"""Scene-axis communication model (parallel/scene_shard.py).

A scene axis replicates rays and partitions the geometry over devices;
per bounce it all-gathers (t, tri) winners, psums the shadow occlusion
and psums the winner's shading row.  scene_axis_comm_model counts those
bytes per device per wave."""

import pytest

from pathtracer_tpu.parallel import scene_shard


def test_comm_model_shapes():
    cm = scene_shard.scene_axis_comm_model(1920 * 1080, 8, 3, 16)
    assert cm['total_bytes_per_device_per_wave'] == (
        cm['allgather_closest_bytes'] + cm['psum_shadow_bytes']
        + cm['psum_shade_bytes'])
    # zero at D=1
    c1 = scene_shard.scene_axis_comm_model(1920 * 1080, 1, 3, 16)
    assert c1['total_bytes_per_device_per_wave'] == 0


@pytest.mark.parametrize('d', [2, 4, 8])
def test_comm_model_grows_with_devices(d):
    small = scene_shard.scene_axis_comm_model(1 << 20, d, 3, 16)
    big = scene_shard.scene_axis_comm_model(1 << 20, 2 * d, 3, 16)
    assert (big['total_bytes_per_device_per_wave']
            > small['total_bytes_per_device_per_wave'])
    # the closest-hit all-gather receives (D-1) * N * 8 bytes per bounce
    assert small['allgather_closest_bytes'] == (d - 1) * (1 << 20) * 8 * 3
