"""The GPU trace kernel (ops/trace_kernel.py) in Triton interpret mode.

Tiny shapes: the interpreter runs every lane of every block in Python-
driven numpy, so a 32x16 frame at depth 3 is the scale that keeps this
file inside the quick tier.  On a GPU, chip_smoke.py runs the same
comparisons compiled and at full width."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.cli import pick_engine
from parallelraytracing_tpu.core.camera import default_camera
from parallelraytracing_tpu.core.mesh import icosphere
from parallelraytracing_tpu.ops import trace_kernel as tk
from parallelraytracing_tpu.ops.intersect import intersect_scene

CFG = RenderConfig(width=32, height=16, max_depth=3, seed=0,
                   intersect_chunk=32, ray_tile=1 << 12)
KERNEL_ENGINES = ("fused", "wavefront_fused", "sharded", "adaptive")


def mesh_scene(level=1, instanced=False):
    s = Scene(preset=None)
    red = s.add_lambertian((0.9, 0.2, 0.2))
    mesh = icosphere(level)
    if instanced:
        s.add_mesh_instances(
            mesh, red, [((1, 1, 1), (0, 30 * i, 0), (i * 3.0 - 3.0, 1, 0))
                        for i in range(3)])
    else:
        s.add_mesh(mesh, red, ((2, 2, 2), (0, 0, 0), (0, 2, 0)))
    g = s.add_lambertian((0.5, 0.5, 0.5))
    s.add_quad(30, 30, g, None)
    light = s.add_emissive((10, 10, 10))
    s.add_sphere(1.0, light, ((1, 1, 1), (0, 0, 0), (4, 8, 4)))
    return s


SCENES = {
    "material_test": lambda: Scene(ScenePreset.MATERIAL_TEST),
    "cornell": lambda: Scene(ScenePreset.CORNELL),
    "random_balls_small": lambda: Scene(ScenePreset.RANDOM_BALLS_SMALL),
    "mesh": mesh_scene,
}


def rays(n, seed=0):
    """n rays: half from a camera-like eye, half from random points."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    eye = jnp.broadcast_to(jnp.array([5.0, 5.0, 8.0]), (n // 2, 3))
    o = jnp.concatenate([eye, jax.random.uniform(k1, (n - n // 2, 3),
                                                 minval=-4.0, maxval=4.0)])
    tgt = jax.random.uniform(k2, (n, 3), minval=-3.0, maxval=3.0)
    d = jnp.where(jnp.arange(n)[:, None] < n // 2, tgt - o,
                  jax.random.normal(k3, (n, 3)))
    return o, d / jnp.linalg.norm(d, axis=1, keepdims=True)


def render(engine, scene_fn, cfg=CFG, frames=2, **attrs):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if engine in KERNEL_ENGINES:
        r.interpret = True
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, scene_fn(), default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_hit_matches_intersect(name):
    """Per-ray closest hit (t and global primitive ordinal) of the
    kernel's BVH walk against the brute-force jnp oracle."""
    scene = SCENES[name]()
    tables = tk.pack_scene(scene, nee=False)
    data = scene.build()
    o, d = rays(256)
    t, ordv = tk.closest_hit(tables, o, d, CFG, interpret=True)
    ref = intersect_scene(data, o, d, CFG.t_min, CFG.t_max, chunk=32)
    n_sph = data.sph_center.shape[0]
    n_quad = data.quad_normal.shape[0]
    base = jnp.where(ref.kind == 0, 0, jnp.where(ref.kind == 1, n_sph,
                                                 n_sph + n_quad))
    ref_ord = np.where(np.asarray(ref.hit), np.asarray(base + ref.idx), -1)
    t, ordv = np.asarray(t), np.asarray(ordv)
    np.testing.assert_array_equal(ordv >= 0, np.asarray(ref.hit))
    assert (ordv == ref_ord).mean() >= 0.99
    hit = ordv >= 0
    assert hit.any() and (~hit).any()
    # the kernel tests spheres in centered form, the oracle expanded:
    # a few ulps of the radius squared apart
    np.testing.assert_allclose(t[hit], np.asarray(ref.t)[hit], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("n", [1, 200, tk.BLOCK + 3])
def test_block_padding_does_not_change_results(n):
    """Ray counts that are not a multiple of the block pad with dead
    rays; the live rays' results equal those of a whole-block launch."""
    tables = tk.pack_scene(Scene(ScenePreset.MATERIAL_TEST), nee=False)
    assert 256 % tk.BLOCK == 0  # the reference launch is whole blocks
    o, d = rays(256, seed=1)
    pix = jnp.arange(256, dtype=jnp.int32)
    full = tk.trace_paths(tables, o, d, pix, 7, CFG, interpret=True)
    part = tk.trace_paths(tables, o[:n], d[:n], pix[:n], 7, CFG,
                          interpret=True)
    assert part.shape == (n, 3)
    np.testing.assert_array_equal(np.asarray(part), np.asarray(full)[:n])
    t_full, _ = tk.closest_hit(tables, o, d, CFG, interpret=True)
    t_part, _ = tk.closest_hit(tables, o[:n], d[:n], CFG, interpret=True)
    np.testing.assert_array_equal(np.asarray(t_part), np.asarray(t_full)[:n])


def test_segment_wrapper_shapes_and_dead_slots():
    """trace_segment returns the 13 state planes; slots >= count stay
    dead and keep their radiance at zero."""
    tables = tk.pack_scene(Scene(ScenePreset.MATERIAL_TEST), nee=False)
    rp = 128
    assert rp % tk.BLOCK == 0
    o, d = rays(rp, seed=2)
    state = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]] \
        + [jnp.ones(rp)] * 3 + [jnp.zeros(rp)] * 3 + [jnp.ones(rp)]
    pix = jnp.arange(rp, dtype=jnp.int32)
    out = tk.trace_segment(tables, pix, state, 3, 0, 100, 2, CFG,
                           interpret=True)
    assert len(out) == 13 and all(p.shape == (rp,) for p in out)
    assert np.all(np.asarray(out[12])[100:] == 0.0)
    assert np.all(np.asarray(jnp.stack(out[9:12]))[:, 100:] == 0.0)
    assert np.asarray(jnp.stack(out[9:12]))[:, :100].max() > 0.0


@pytest.mark.parametrize("preset,nee", [(ScenePreset.MATERIAL_TEST, False),
                                        (ScenePreset.CORNELL, True)])
def test_fused_bitmatches_wavefront_fused(preset, nee):
    """RNG keyed on (pixel, absolute depth): compaction, re-sorting and
    the segment schedule cannot change the image."""
    cfg = CFG.replace(nee=nee, max_depth=4)
    scene = lambda: Scene(preset)
    a = render("fused", scene, cfg)
    b = render("wavefront_fused", scene, cfg, schedule=(1, 2))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.max() > 0.0


def test_fused_matches_megakernel_oracle_statistically():
    """Different RNG streams, same estimator: the converged means agree."""
    cfg = CFG.replace(samples_per_frame=16)
    scene = lambda: Scene(ScenePreset.MATERIAL_TEST)
    a = render("fused", scene, cfg, frames=2)
    b = render("megakernel", scene, cfg, frames=2)
    assert abs(a.mean() - b.mean()) / b.mean() < 0.05


@pytest.mark.parametrize("spp_axis", [1, 2])
def test_sharded_on_eight_devices_matches_fused(spp_axis):
    """The kernel under shard_map over 8 virtual CPU devices: spp axis 1
    is the fused image bit for bit; spp axis 2 averages two sample
    streams, so it agrees statistically."""
    assert len(jax.devices()) == 8
    scene = lambda: Scene(ScenePreset.MATERIAL_TEST)
    cfg = CFG.replace(jitter=False)
    a = render("sharded", scene, cfg, spp_axis=spp_axis)
    b = render("fused", scene, cfg)
    if spp_axis == 1:
        np.testing.assert_array_equal(a, b)
    else:
        assert abs(a.mean() - b.mean()) / b.mean() < 0.1


def test_sharded_mesh_scene_matches_fused():
    """A triangle-heavy scene over 8 devices equals the single-device
    fused image bit for bit."""
    scene = lambda: mesh_scene(level=3)
    cfg = CFG.replace(jitter=False)
    np.testing.assert_array_equal(render("sharded", scene, cfg, frames=1),
                                  render("fused", scene, cfg, frames=1))


@pytest.mark.parametrize("platform,scene,engine", [
    ("gpu", "material_test", "fused"),
    ("gpu", "mesh", "fused"),
    ("gpu", "instanced", "fused"),
    ("cpu", "material_test", "megakernel"),
    ("cpu", "mesh", "bvh"),
])
def test_auto_routing(platform, scene, engine):
    scenes = {"material_test": lambda: Scene(ScenePreset.MATERIAL_TEST),
              "mesh": lambda: mesh_scene(level=4),
              "instanced": lambda: mesh_scene(level=3, instanced=True)}
    assert pick_engine(scenes[scene](), platform) == engine


@pytest.mark.parametrize("engine", KERNEL_ENGINES)
def test_kernel_engines_refuse_cpu_without_interpret(engine):
    r = create_renderer(engine)
    film = Film(CFG.width, CFG.height)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        r.init(film, Scene(ScenePreset.MATERIAL_TEST),
               default_camera(CFG.width, CFG.height), CFG)


def test_bvh_build_is_a_threaded_preorder():
    """Every primitive sits in exactly one leaf; miss links point
    forward (or end the walk); children lie inside their parents."""
    rng = np.random.default_rng(0)
    c = rng.uniform(-5, 5, (300, 3))
    perm, nodes = tk.build_bvh(c - 0.1, c + 0.1)
    assert sorted(perm.tolist()) == list(range(300))
    miss, enc = tk.node_links(nodes)
    m = len(nodes)
    assert np.all((miss == -1) | (miss > np.arange(m)))
    leaves = enc >= 0
    counts = enc[leaves] & ((1 << tk.LEAF_BITS) - 1)
    assert counts.sum() == 300 and counts.max() <= tk.LEAF
    inner = np.nonzero(~leaves)[0]
    for i in inner:  # preorder: the left child is the next row
        assert np.all(nodes[i + 1, 0:3] >= nodes[i, 0:3])
        assert np.all(nodes[i + 1, 3:6] <= nodes[i, 3:6])


def test_oracle_gates_run_at_a_tiny_size():
    """The gate suite bench.py and chip_smoke.py run on the GPU, here at
    16x12 and 4 spp: every gate reports, and the exact gates pass."""
    from parallelraytracing_tpu.utils.fidelity import run_gates
    res = run_gates(spp=4, width=16, height=12, interpret=True,
                    log=lambda s: None)
    assert len(res) == 7 and "pass" in res
    assert res["material_test fused==wavefront_fused"]["pass"]
    assert res["material_test bvh==megakernel"]["pass"]
    for name, v in res.items():
        if name != "pass":
            assert np.isfinite(v.get("rmse", 0.0)), name
