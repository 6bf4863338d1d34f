"""Train the KPCN-lite denoiser on this renderer's own output.

Self-supervised-by-spp: procedurally sampled analytic scenes rendered
at 4 spp (noisy input + albedo/normal aux) and 128 spp (target) by the
SAME integrator, then a kernel-predicting CNN (render/denoise_net.py)
learns to map one to the other on random crops.  This is the OIDN-slot
model (reference: Raytracer.cpp:1721-1746) trained end to end on the
accelerator — the renderer produces its own supervision, no external data.

Run on the GPU:  timeout 3000 python scripts/train_denoiser.py
Writes pathtracer_tpu/render/denoiser_weights.npz when the trained
model beats the noisy input by >=2x MSE on a held-out scene.
"""

import sys
import time

import numpy as np

sys.path.insert(0, '/root/repo')

import jax                      # noqa: E402
import jax.numpy as jnp        # noqa: E402
import optax                    # noqa: E402

import pathtracer_tpu as pt    # noqa: E402
from pathtracer_tpu.render import denoise_net as dnn   # noqa: E402
from pathtracer_tpu.render import renderer as rnd      # noqa: E402
from pathtracer_tpu.scene import scene as scn          # noqa: E402

W, H = 256, 144
SPP_IN, SPP_TGT = 4, 128
N_SCENES = 10
CROP, BATCH, STEPS = 64, 8, 1500


def log(*a):
    print(*a, flush=True)


def sample_scene(seed):
    rng = np.random.default_rng(seed)
    objs = scn.default_objects()
    for _ in range(int(rng.integers(3, 7))):
        c = (float(rng.uniform(-25, 25)), float(rng.uniform(-24, 0)),
             float(rng.uniform(-20, 10)))
        r = float(rng.uniform(2.5, 8.0))
        kind = rng.random()
        if kind < 0.15:
            objs.append(pt.sphere(c, r, miroir=True))
        elif kind < 0.3:
            objs.append(pt.sphere(c, r, transp=True,
                                  refr_index=float(rng.uniform(1.2, 1.6))))
        else:
            kd = tuple(float(x) for x in rng.uniform(0.1, 0.9, 3))
            ks = tuple(float(x) for x in rng.uniform(0.0, 0.4, 3))
            ne = (float(rng.uniform(5, 200)),) * 3
            objs.append(pt.sphere(c, r, kd=kd, ks=ks, ne=ne))
    return pt.build_scene(objs, pt.default_light_intensity()
                          * float(rng.uniform(0.5, 2.0)))


def render_buffers(sc, cam, spp):
    cfg = rnd.RenderConfig(width=W, height=H, nrays=spp,
                           samples_per_wave=spp, has_denoiser=True)
    r = rnd.Renderer(sc, cam, cfg)
    r.step(spp)
    color, albedo, normal = (np.asarray(a) / spp for a in r.aux)
    return color, albedo, normal


def main():
    log('devices:', jax.devices())
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    data = []
    t0 = time.perf_counter()
    for s in range(N_SCENES + 1):                 # last = held-out
        sc = sample_scene(1000 + s)
        cin, alb, nrm = render_buffers(sc, cam, SPP_IN)
        ctgt, _, _ = render_buffers(sc, cam, SPP_TGT)
        data.append((cin, alb, nrm, ctgt))
        log(f'scene {s}: rendered ({time.perf_counter() - t0:.0f}s)')
    train, held = data[:-1], data[-1]

    params = dnn.init_params(jax.random.PRNGKey(0))
    tx = optax.adam(optax.cosine_decay_schedule(2e-3, STEPS))
    opt = tx.init(params)

    def loss_fn(params, cin, alb, nrm, ctgt):
        out = jax.vmap(lambda c, a, n: dnn.denoise_apply(params, c, a, n)
                       )(cin, alb, nrm)
        return jnp.mean(jnp.abs(jnp.log1p(out) - jnp.log1p(ctgt)))

    @jax.jit
    def step(params, opt, batch):
        l, g = jax.value_and_grad(loss_fn)(params, *batch)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(params, up), opt, l

    rng = np.random.default_rng(7)

    def make_batch():
        out = [[], [], [], []]
        for _ in range(BATCH):
            cin, alb, nrm, ctgt = train[rng.integers(len(train))]
            i = rng.integers(0, H - CROP)
            j = rng.integers(0, W - CROP)
            sl = np.s_[i:i + CROP, j:j + CROP]
            for k, buf in enumerate((cin, alb, nrm, ctgt)):
                out[k].append(buf[sl])
        return tuple(jnp.asarray(np.stack(x)) for x in out)

    t0 = time.perf_counter()
    for it in range(STEPS):
        params, opt, l = step(params, opt, make_batch())
        if it % 150 == 0:
            log(f'step {it}: loss {float(l):.4f} '
                f'({time.perf_counter() - t0:.0f}s)')

    cin, alb, nrm, ctgt = held
    out = np.asarray(dnn.denoise_apply(
        params, jnp.asarray(cin), jnp.asarray(alb), jnp.asarray(nrm)))

    def mse(a):
        return float(np.mean((np.log1p(np.maximum(a, 0))
                              - np.log1p(ctgt)) ** 2))

    m_noisy, m_dn = mse(cin), mse(out)
    from pathtracer_tpu.render import denoise as dn
    m_at = mse(np.asarray(dn.atrous_denoise(cin, alb, nrm)))
    log(f'held-out log-MSE: noisy {m_noisy:.5f}  atrous {m_at:.5f}  '
        f'learned {m_dn:.5f}')
    if m_dn * 2.0 <= m_noisy:
        dnn.save_weights(params)
        log('saved', dnn.WEIGHTS_PATH)
    else:
        log('NOT saved: model does not beat noisy by 2x')


if __name__ == '__main__':
    main()
