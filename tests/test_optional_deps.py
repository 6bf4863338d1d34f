"""The render path needs neither flax nor Pillow: import the package,
render, and save a PNG in a fresh interpreter where both are blocked."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pathtracer_tpu.io import image as image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r'''
import sys
for name in ('flax', 'flax.struct', 'flax.linen', 'PIL', 'PIL.Image'):
    sys.modules[name] = None          # import of any of them now fails
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
import pathtracer_tpu as pt
from pathtracer_tpu.io import image as image_io
from pathtracer_tpu.render import denoise_net
from pathtracer_tpu.scene import scene as scn
from pathtracer_tpu.utils import procgen

objs = scn.default_objects()
objs.append(scn.mesh_object(procgen.sphere_mesh(6, 6, radius=8.0),
                            translation=(0.0, -17.0, 0.0)))
sc = pt.build_scene(objs, pt.default_light_intensity())
cam = pt.make_camera((0, 0, 50), (0, 0, -1), (0, 1, 0))
r = pt.Renderer(sc, cam, pt.RenderConfig(width=16, height=12, nrays=1,
                                         nb_bounces=2)).render()
image_io.save_image(sys.argv[1], r.u8())
assert denoise_net.load_weights() is not None
try:
    image_io.load_image(sys.argv[1])
except ImportError as e:
    assert 'Pillow' in str(e)
else:
    raise AssertionError('load_image worked without Pillow')
print('OK')
'''


def test_render_and_png_without_flax_or_pillow(tmp_path):
    out = tmp_path / 'img.png'
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                              ''))
    res = subprocess.run([sys.executable, '-c', _SCRIPT, str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0 and 'OK' in res.stdout, res.stderr[-3000:]
    data = out.read_bytes()
    assert data[:8] == b'\x89PNG\r\n\x1a\n'


@pytest.mark.parametrize('shape', [(5, 7, 3), (4, 4), (3, 9, 4)])
def test_png_encoder_round_trips(tmp_path, shape):
    Image = pytest.importorskip('PIL.Image')
    img = (np.random.default_rng(0).random(shape) * 255).astype(np.uint8)
    p = tmp_path / 'x.png'
    image_io.save_image(str(p), img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
