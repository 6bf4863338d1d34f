"""Two-process CPU multi-host worker (launched by test_multihost.py).

Each process owns 4 virtual CPU devices; `init_multihost` wires the two
processes into one 8-device runtime (Gloo collectives), and the SAME
process-agnostic `make_sharded_render` used on a pod slice renders the
image with rows sharded over the global 'dp' axis — film partials psum
across processes over DCN-analogue collectives.  The worker then proves
the host-local assembly path: it slices ITS OWN rows out (what a real
multi-host film would materialize locally, `host_shard_rows`) and
rebuilds the global image with `jax.make_array_from_process_local_data`.

The reference never scaled past one box (OpenMP rows, Raytracer.cpp);
this is the multi-host replacement's smallest end-to-end proof.
"""

import os
import sys

# env must be set before jax imports: each process gets 4 local devices
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

PID = int(sys.argv[1])
NPROC = int(sys.argv[2])
PORT = sys.argv[3]
OUT = sys.argv[4]

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
# cross-process CPU collectives (the DCN analogue) ride Gloo
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracer_tpu.parallel import distributed as dist
from pathtracer_tpu.parallel import sharding as shd
from pathtracer_tpu.render import renderer as rnd
from pathtracer_tpu.render import film as film_mod
from pathtracer_tpu.core import rng_host
from pathtracer_tpu.scene import scene as scn
import pathtracer_tpu as pt


def main():
    pid, nproc = dist.init_multihost(
        coordinator_address=f"localhost:{PORT}",
        num_processes=NPROC, process_id=PID)
    assert nproc == NPROC and pid == PID
    assert len(jax.devices()) == 4 * NPROC, jax.devices()

    W, H, SPP = 24, 16, 2
    mesh = dist.global_mesh(sp=1)            # dp=8 over both processes
    sc = scn.build_scene(scn.default_objects(),
                         scn.default_light_intensity())
    cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
    cfg = rnd.RenderConfig(width=W, height=H, nrays=SPP, nb_bounces=2,
                           samples_per_wave=SPP)
    film = film_mod.make_film(W, H, cfg.sigma_filter)
    render = shd.make_sharded_render(mesh, cfg, film.ratio)
    cp = np.asarray(rng_host.random_per_pixel_fast(W, H))
    image, count = render(sc, cam, cp)
    # the sharded render returns the PADDED film accumulators (splat
    # windows cross shard borders); crop to the visible HxW image
    image = np.asarray(film_mod.crop(film, image))
    count = np.asarray(film_mod.crop(film, count))

    # host-local film assembly: keep only this process's rows, rebuild
    # the global image without funneling pixels through one host
    row0, row1, _ = dist.host_shard_rows(H, mesh)
    local_rows = image[row0:row1]
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh1d = jax.sharding.Mesh(
        np.asarray(mesh.devices).reshape(-1), ("dp",))
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh1d, P("dp")), local_rows, (H, W, 3))
    reassembled = np.asarray(
        jax.jit(lambda x: x, out_shardings=NamedSharding(mesh1d, P()))(
            garr))
    assert np.allclose(reassembled, image, atol=1e-6), (
        "host-shard reassembly mismatch")

    if PID == 0:
        np.savez(OUT, image=image, count=count)
    print(f"worker {PID}: ok", flush=True)


if __name__ == "__main__":
    main()
