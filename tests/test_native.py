"""Native library (C++ LBVH/PLY/PNG) parity vs the pure-Python reference
implementations. Skipped when _native.so hasn't been built (make -C native)."""

import numpy as np
import pytest

from parallelraytracing_tpu import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def test_lbvh_matches_python_builder():
    from parallelraytracing_tpu import Scene, ScenePreset
    from parallelraytracing_tpu.accel import lbvh as L

    scene = Scene(ScenePreset.RANDOM_BALLS_SMALL).build()
    mn, mx, kind, idx = L.scene_primitive_aabbs(scene)
    py = L._build_bvh_python(scene, mn, mx, kind, idx)
    nat = L._assemble_bvh_native(scene, mn, mx, kind, idx, py.node_min.dtype)
    np.testing.assert_array_equal(np.asarray(py.node_miss), np.asarray(nat.node_miss))
    np.testing.assert_array_equal(np.asarray(py.node_kind), np.asarray(nat.node_kind))
    np.testing.assert_array_equal(np.asarray(py.node_idx), np.asarray(nat.node_idx))
    np.testing.assert_array_equal(np.asarray(py.node_ord), np.asarray(nat.node_ord))
    np.testing.assert_allclose(np.asarray(py.node_min), np.asarray(nat.node_min),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(py.node_max), np.asarray(nat.node_max),
                               rtol=1e-6)


def test_lbvh_large_random():
    rng = np.random.RandomState(1)
    c = rng.uniform(-50, 50, (5000, 3))
    r = rng.uniform(0.01, 0.5, (5000, 1))
    node_min, node_max, leaf, payload, miss, order = native.build_lbvh(c - r, c + r)
    m = 2 * 5000 - 1
    assert len(miss) == m
    assert leaf.sum() == 5000
    assert sorted(payload[leaf]) == list(range(5000))
    assert sorted(order) == list(range(5000))
    # escape links strictly forward or -1
    assert np.all((miss == -1) | (miss > np.arange(m)))
    # root AABB contains everything
    np.testing.assert_array_less(node_min[0] - 1e-9, (c - r).min(0))
    np.testing.assert_array_less((c + r).max(0), node_max[0] + 1e-9)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_matches_python_loader(tmp_path, binary):
    from parallelraytracing_tpu.core.mesh import (_load_ply_python,
                                                  icosphere, save_ply)

    for level in (1, 3):
        path = str(tmp_path / f"ico{level}.ply")
        save_ply(path, icosphere(level, seed=level), binary=binary)
        py = _load_ply_python(path)
        v, n, uv, idx = native.load_ply(path)
        np.testing.assert_allclose(py.vertices, v, rtol=1e-6)
        np.testing.assert_array_equal(py.indices, idx)
        if py.normals is not None:
            np.testing.assert_allclose(py.normals, n, atol=1e-6)


def test_png_roundtrip_via_python_reader():
    from parallelraytracing_tpu.utils.png import read_png

    rng = np.random.RandomState(0)
    img = (rng.rand(33, 47, 4) * 255).astype(np.uint8)
    data = native.encode_png(img)
    import tempfile, os
    with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        back = read_png(path)
        np.testing.assert_array_equal(back, img)
    finally:
        os.unlink(path)


# ---------------------------------------------------------------- hardening
# The parser consumes untrusted files (cli.py --ply): every malformed input
# must fail cleanly (IOError from a nullptr handle), never over-read.

def _expect_reject(tmp_path, name, content: bytes):
    p = tmp_path / name
    p.write_bytes(content)
    with pytest.raises(IOError):
        native.load_ply(str(p))


def test_ply_truncated_binary_rejected(tmp_path):
    head = (b"ply\nformat binary_little_endian 1.0\n"
            b"element vertex 100\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"end_header\n")
    # promises 100 vertices, delivers 2
    _expect_reject(tmp_path, "trunc.ply", head + b"\x00" * 24)


def test_ply_huge_list_count_rejected(tmp_path):
    head = (b"ply\nformat binary_little_endian 1.0\n"
            b"element vertex 1\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 1\n"
            b"property list uint32 uint32 vertex_indices\n"
            b"end_header\n")
    body = b"\x00" * 12 + (0xFFFFFFFF).to_bytes(4, "little") + b"\x00" * 8
    _expect_reject(tmp_path, "biglist.ply", head + body)


def test_ply_vertex_missing_y_rejected(tmp_path):
    head = (b"ply\nformat ascii 1.0\n"
            b"element vertex 1\nproperty float x\n"
            b"end_header\n1.0\n")
    _expect_reject(tmp_path, "noy.ply", head)


def test_ply_ascii_missing_tokens_rejected(tmp_path):
    head = (b"ply\nformat ascii 1.0\n"
            b"element vertex 3\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"end_header\n1 2 3\n4 5\n")
    _expect_reject(tmp_path, "fewtoks.ply", head)


def test_ply_out_of_range_index_rejected(tmp_path):
    head = (b"ply\nformat ascii 1.0\n"
            b"element vertex 3\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 1\n"
            b"property list uchar int vertex_indices\n"
            b"end_header\n"
            b"0 0 0\n1 0 0\n0 1 0\n"
            b"3 0 1 7\n")  # vertex 7 of 3
    _expect_reject(tmp_path, "badidx.ply", head)


def test_ply_negative_index_rejected(tmp_path):
    head = (b"ply\nformat ascii 1.0\n"
            b"element vertex 3\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 1\n"
            b"property list uchar int vertex_indices\n"
            b"end_header\n"
            b"0 0 0\n1 0 0\n0 1 0\n"
            b"3 0 1 -1\n")
    _expect_reject(tmp_path, "negidx.ply", head)
