"""Headless CLI — the reference's scriptable entry point.

`python -m pathtracer_tpu.cli scene.json [out.png] [name-substitution]`
mirrors `rayTracer scene.scn [out.img] [name-substitution]`
(reference: mainApp.cpp:38-49): load the scene, run the offline render,
save the image, exit.  `--progressive` streams preview saves per wave (the
render_image autosave path, Raytracer.cpp:1549-1558).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('scene', help='scene JSON path')
    p.add_argument('output', nargs='?', default='export.png')
    p.add_argument('name_subst', nargs='?', default=None,
                   help="replaces '#' in mesh paths (batch renders)")
    p.add_argument('--spp', type=int, default=None, help='override nrays')
    p.add_argument('--size', type=str, default=None, help='WxH override')
    p.add_argument('--cpu', action='store_true',
                   help='render on the CPU (an explicit choice; nothing '
                        'falls back to it silently)')
    p.add_argument('--progressive', action='store_true',
                   help='save preview after every wave')
    p.add_argument('--frame', type=int, default=0,
                   help='animation frame to evaluate keyframes at (also '
                        'the autosave index)')
    p.add_argument('--autosave', action='store_true',
                   help="per-frame autosaves next to the output: "
                        "exportD<frame>.jpg each progressive wave, "
                        "exportE<frame>.jpg after the offline render "
                        "(reference naming, Raytracer.cpp:1549-1558, "
                        ":1711-1756)")
    p.add_argument('--denoise', action='store_true',
                   help='also save exportEFiltered<frame>.jpg (a-trous '
                        'denoise of the aux buffers)')
    p.add_argument('--checkpoint', metavar='PATH.npz', default=None,
                   help='preemption-safe render: resume PATH if present, '
                        'checkpoint there on SIGTERM/SIGINT and every '
                        'wave; removed when the render completes')
    p.add_argument('--save-scn', metavar='PATH.scn', default=None,
                   help='write the loaded scene back out in the '
                        "reference's text .scn format (save_scene, "
                        'Raytracer.cpp:1096-1146) and continue')
    args = p.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')
    from .utils import compile_cache
    compile_cache.enable()

    from .io import image as image_io
    from .io import scene_json
    from .render.renderer import Renderer
    from .scene import scene as scn

    if args.scene.lower().endswith('.scn'):
        # the reference's text format (Raytracer.cpp:1096-1236)
        from .io import scn_import
        objects, light_intensity, cam, cfg, extras = scn_import.load_scn(
            args.scene, args.name_subst)
    else:
        objects, light_intensity, cam, cfg, extras = scene_json.load_scene(
            args.scene, args.name_subst)
    if args.spp:
        cfg = cfg._replace(nrays=args.spp)
    if args.size:
        w, h = (int(x) for x in args.size.split('x'))
        cfg = cfg._replace(width=w, height=h)
    if args.save_scn:
        from .io import scn_export
        scn_export.save_scn(args.save_scn, objects, light_intensity, cam,
                            cfg, extras)
        print(f'saved {args.save_scn}', flush=True)

    import os

    envmap = None
    if extras.get('envmap'):
        from .io.image import load_hdr, load_image
        ep = extras['envmap']
        if not os.path.isabs(ep):
            ep = os.path.join(os.path.dirname(os.path.abspath(args.scene)),
                              ep)
        envmap = (load_hdr(ep) if ep.lower().endswith('.hdr')
                  else load_image(ep))

    background = None
    if extras.get('background'):
        bp = extras['background']
        if not os.path.isabs(bp):
            bp = os.path.join(os.path.dirname(os.path.abspath(args.scene)),
                              bp)
        background = scn.load_background(bp)

    if args.denoise:
        cfg = cfg._replace(has_denoiser=True)
    sc = scn.build_scene(objects, light_intensity,
                         envmap_intensity=extras.get('envmap_intensity', 1.0),
                         envmap=envmap, background=background,
                         fog=extras.get('fog'),
                         frame=args.frame if args.frame else None)

    out_dir = os.path.dirname(os.path.abspath(args.output))

    def save(path, img_u8):
        image_io.save_image(path, img_u8)
        print(f'saved {path}', flush=True)

    r = Renderer(sc, cam, cfg)
    t0 = time.perf_counter()
    if args.progressive:
        from .render import film as film_mod
        # instant dense preview before the first full wave (the
        # reference's 1/16^2 low-res fill-in, Raytracer.cpp:1508-1510 /
        # mainApp.cpp:1214-1240): 1/256 of the rays, seconds not minutes
        # on office-scale scenes
        r.preview()
        image_io.save_image(args.output, film_mod.to_u8(r.display_fill_in()))
        print('saved low-res preview', flush=True)
        while r.samples_done < cfg.nrays:
            r.step(min(cfg.samples_per_wave, cfg.nrays - r.samples_done))
            u8 = film_mod.to_u8(r.display_fill_in())
            image_io.save_image(args.output, u8)
            if args.autosave:
                # progressive autosave slot (Raytracer.cpp:1549-1558)
                save(os.path.join(out_dir, f'exportD{args.frame}.jpg'), u8)
            dt = time.perf_counter() - t0
            print(f'{r.samples_done}/{cfg.nrays} spp  '
                  f'{dt / max(r.samples_done, 1):.2f} s/spp', flush=True)
    elif args.checkpoint:
        from .parallel.distributed import PreemptionGuard
        with PreemptionGuard() as guard:
            r.render_resumable(args.checkpoint, guard=guard,
                               save_every=cfg.samples_per_wave)
        if r.samples_done < cfg.nrays:
            print(f'preempted at {r.samples_done}/{cfg.nrays} spp; '
                  f'state in {args.checkpoint}', flush=True)
            return 75    # EX_TEMPFAIL: retry me
    else:
        r.render()
    dt = time.perf_counter() - t0
    st = r.stats(dt)
    print(f'rendered {cfg.width}x{cfg.height} @{cfg.nrays}spp in {dt:.1f}s '
          f'({st["rays_per_second"] / 1e6:.1f}M live rays/s)')
    if args.output.lower().endswith('.hdr'):
        import numpy as np
        image_io.save_hdr(args.output, np.asarray(r.hdr()))
        print(f'saved {args.output}')
    else:
        save(args.output, r.u8())
    if args.autosave:
        # offline autosave slot (Raytracer.cpp:1711-1756)
        save(os.path.join(out_dir, f'exportE{args.frame}.jpg'), r.u8())
        if args.denoise:
            from .render import film as film_mod
            u8 = film_mod.to_u8(r.denoised_display())
            save(os.path.join(out_dir,
                              f'exportEFiltered{args.frame}.jpg'), u8)
    return 0


if __name__ == '__main__':
    sys.exit(main())
