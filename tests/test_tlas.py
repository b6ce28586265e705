"""Two-level BVH (TLAS/BLAS) instancing: correctness vs the baked oracle
and the memory-proportional-to-unique-meshes property (the reference's
IAS-over-GAS design, optix/renderer.cpp:833-870)."""

import numpy as np
import pytest

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import Camera, default_camera
from parallelraytracing_tpu.core.mesh import icosphere

pytestmark = pytest.mark.slow  # TLAS interpret renders



def instanced_scene():
    mesh = icosphere(0)
    s = Scene(preset=None)
    red = s.add_lambertian((0.9, 0.2, 0.2))
    metal = s.add_metal((0.9, 0.9, 0.9), 0.05)
    s.add_mesh_instances(mesh, red,
                         [((1, 1, 1), (0, 30 * i, 0), (i * 3.0 - 3.0, 1, 0))
                          for i in range(3)])
    s.add_mesh_instances(mesh, metal, [((2, 2, 2), (0, 0, 45), (0, 2, -4))])
    g = s.add_lambertian((0.5, 0.5, 0.5))
    s.add_quad(30, 30, g, None)
    light = s.add_emissive((10, 10, 10))
    s.add_sphere(1.0, light, ((1, 1, 1), (0, 0, 0), (4, 8, 4)))
    return s, mesh


CFG = RenderConfig(width=64, height=40, max_depth=5, seed=5,
                   intersect_chunk=32, ray_tile=1 << 16)


def render(engine, scene, frames=6, cfg=CFG):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    r.init(film, scene, default_camera(cfg.width, cfg.height), cfg)
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average())


def test_memory_proportional_to_unique_meshes():
    s, mesh = instanced_scene()
    base, tl = s.build_two_level()
    n_mesh_tris = len(np.asarray(mesh.indices)) // 3
    assert tl.num_unique_triangles == n_mesh_tris  # ONE copy for 4 instances
    assert tl.num_instances == 4
    # base scene excludes the instanced geometry
    assert int(np.asarray(base.tri_valid).sum()) == 0
    # flat build for non-instancing engines still carries all 4 copies
    flat = s.build()
    assert int(np.asarray(flat.tri_valid).sum()) == 4 * n_mesh_tris


def test_tlas_ref_matches_baked_oracle():
    s, _ = instanced_scene()
    img_tlas = render("tlas_ref", s)
    s2, _ = instanced_scene()
    img_oracle = render("megakernel", s2)
    rmse = float(np.sqrt(np.mean((img_tlas - img_oracle) ** 2)))
    # Same RNG streams (both key on pixel id via threefry in the jnp
    # loop): the only differences are float associativity in the two
    # traversals, so the images agree to float tolerance, far inside the
    # RMSE<1e-3 acceptance gate.
    assert rmse < 1e-3, f"TLAS vs baked oracle RMSE {rmse}"


def test_tlas_instance_transforms_respected():
    # A scaled instance must differ from an unscaled one.
    mesh = icosphere(0)
    def one(scale):
        s = Scene(preset=None)
        m = s.add_lambertian((0.9, 0.2, 0.2))
        s.add_mesh_instances(mesh, m, [((scale,) * 3, (0, 0, 0), (0, 1, 0))])
        g = s.add_lambertian((0.5, 0.5, 0.5))
        s.add_quad(30, 30, g, None)
        return render("tlas_ref", s, frames=2)
    a = one(1.0)
    b = one(2.0)
    assert np.abs(a - b).max() > 0.01


def test_fused_in_kernel_tlas_matches_baked():
    """The fused engine traces instances natively (in-kernel TLAS/BLAS,
    ops/pallas_trace.py): zero baked triangles, local geometry stored
    once, image agrees with the baked-scene render (same pixel-keyed
    RNG streams; only float transform order differs)."""
    import jax
    from parallelraytracing_tpu.core.mesh import icosphere
    mesh = icosphere(0)

    def make(instanced):
        s = Scene(preset=None)
        red = s.add_lambertian((0.9, 0.2, 0.2))
        metal = s.add_metal((0.9, 0.9, 0.9), 0.05)
        tr_red = [((1, 1, 1), (0, 30 * i, 0), (i * 3.0 - 3.0, 1, 0))
                  for i in range(3)]
        tr_metal = [((2, 2, 2), (0, 0, 45), (0, 2, -4))]
        if instanced:
            s.add_mesh_instances(mesh, red, tr_red)
            s.add_mesh_instances(mesh, metal, tr_metal)
        else:
            for t in tr_red:
                s.add_mesh(mesh, red, t)
            for t in tr_metal:
                s.add_mesh(mesh, metal, t)
        g = s.add_lambertian((0.5, 0.5, 0.5))
        s.add_quad(30, 30, g, None)
        light = s.add_emissive((10, 10, 10))
        s.add_sphere(1.0, light, ((1, 1, 1), (0, 0, 0), (4, 8, 4)))
        return s

    cfg = RenderConfig(width=48, height=32, max_depth=4, seed=5,
                       intersect_chunk=32)
    imgs = {}
    for tag, inst in (("baked", False), ("tlas", True)):
        film = Film(cfg.width, cfg.height)
        r = create_renderer("fused")
        r.interpret = True  # Triton interpret mode on CPU
        r.init(film, make(inst), default_camera(cfg.width, cfg.height), cfg)
        if inst:
            # instanced path active: no baked triangles, geometry stored
            # once for 4 instances
            assert r._tables.inst is not None
            assert int(np.asarray(r._scene_data.tri_valid).sum()) == 0
            n_unique = len(np.asarray(mesh.indices)) // 3
            assert r._tables.itri.shape[0] == n_unique  # stored once
        for _ in range(8):
            r.progressive_render()
        imgs[tag] = np.asarray(film.hdr_average())
    rmse = float(np.sqrt(np.mean((imgs["tlas"] - imgs["baked"]) ** 2)))
    assert rmse < 1e-3, rmse


def test_wavefront_fused_instanced_bitmatches_fused():
    cfg = RenderConfig(width=48, height=32, max_depth=4, seed=5,
                       intersect_chunk=32)
    imgs = {}
    for engine in ("fused", "wavefront_fused"):
        s, _ = instanced_scene()
        film = Film(cfg.width, cfg.height)
        r = create_renderer(engine)
        if hasattr(r, "interpret"):  # a kernel engine
            r.interpret = True
        if engine == "wavefront_fused":
            r.segment = 2
        r.init(film, s, default_camera(cfg.width, cfg.height), cfg)
        assert r._tables.inst is not None  # in-kernel TLAS active in both
        for _ in range(3):
            r.progressive_render()
        imgs[engine] = np.asarray(film.hdr_average())
    np.testing.assert_array_equal(imgs["fused"], imgs["wavefront_fused"])


def test_tlas_engine_is_the_fast_path():
    """`--engine tlas` routes through the fused in-kernel TLAS (the jnp
    mirror was a ~250x-slower trap as the registered engine — VERDICT
    r2); the mirror stays registered as `tlas_ref` for oracle tests."""
    from parallelraytracing_tpu.engines.fused import FusedRenderer
    from parallelraytracing_tpu.engines.tlas import TLASRefRenderer
    assert isinstance(create_renderer("tlas"), FusedRenderer)
    assert isinstance(create_renderer("tlas_ref"), TLASRefRenderer)

    s, _ = instanced_scene()
    cfg = CFG.replace(jitter=False)
    a = render("tlas", s, frames=2, cfg=cfg)
    s2, _ = instanced_scene()
    b = render("fused", s2, frames=2, cfg=cfg)
    np.testing.assert_array_equal(a, b)
