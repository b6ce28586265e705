"""LBVH build + traversal: structural invariants and exact agreement with
the brute-force intersector (SURVEY.md §4: 'brute-force intersect vs BVH
intersect must match exactly at equal rays')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallelraytracing_tpu import Film, RenderConfig, Scene, ScenePreset, create_renderer
from parallelraytracing_tpu.accel.lbvh import (
    _karras_tree, build_bvh, morton3d, thread_tree)
from parallelraytracing_tpu.accel.traverse import bvh_intersect_scene
from parallelraytracing_tpu.core.camera import default_camera
from parallelraytracing_tpu.engines.megakernel import raygen
from parallelraytracing_tpu.ops.intersect import intersect_scene

T_MIN, T_MAX = 1e-3, 1e16


def random_sphere_scene(n, seed=0, spread=20.0):
    s = Scene(preset=None)
    rng = np.random.RandomState(seed)
    for i in range(n):
        mat = s.add_lambertian(rng.uniform(0, 1, 3))
        c = rng.uniform(-spread, spread, 3)
        s.add_sphere(rng.uniform(0.2, 1.5), mat, ((1, 1, 1), (0, 0, 0), c))
    return s


class TestMorton:
    def test_ordering_locality(self):
        pts = np.array([[0.0, 0, 0], [1.0, 1, 1], [0.01, 0, 0]])
        codes = morton3d(pts)
        assert codes[0] < codes[1]
        assert codes[2] < codes[1]

    def test_range(self):
        codes = morton3d(np.random.RandomState(0).uniform(0, 1, (100, 3)))
        assert (codes < (1 << 30)).all()


class TestTreeStructure:
    @pytest.mark.parametrize("n", [2, 3, 5, 17, 100, 809])
    def test_tree_covers_all_leaves_once(self, n):
        rng = np.random.RandomState(n)
        codes = morton3d(rng.uniform(0, 1, (n, 3)))
        order = np.argsort(codes, kind="stable")
        keys = (codes[order].astype(np.uint64) << np.uint64(31)) \
            | np.arange(n, dtype=np.uint64)
        left, right = _karras_tree(keys)
        is_leaf, payload, miss = thread_tree(left, right, n)
        assert len(is_leaf) == 2 * n - 1
        leaves = payload[is_leaf]
        assert sorted(leaves) == list(range(n))  # every leaf exactly once
        # escape links are strictly forward (or -1)
        m = len(is_leaf)
        ok = (miss == -1) | (miss > np.arange(m))
        assert ok.all()

    @pytest.mark.parametrize("preset", [ScenePreset.MATERIAL_TEST,
                                        ScenePreset.RANDOM_BALLS_SMALL])
    def test_internal_aabbs_contain_children(self, preset):
        scene = Scene(preset).build()
        bvh = build_bvh(scene)
        mn = np.asarray(bvh.node_min)
        mx = np.asarray(bvh.node_max)
        miss = np.asarray(bvh.node_miss)
        kind = np.asarray(bvh.node_kind)
        m = len(miss)
        # walk: every node's AABB must contain node+1's if internal
        for i in range(m):
            if kind[i] < 0:  # internal: child is i+1
                assert (mn[i] <= mn[i + 1] + 1e-5).all()
                assert (mx[i] >= mx[i + 1] - 1e-5).all()


class TestTraversalParity:
    @pytest.mark.parametrize("preset", [
        ScenePreset.MATERIAL_TEST, ScenePreset.DEFAULT,
        ScenePreset.CORNELL, ScenePreset.LIGHT_TEST,
        ScenePreset.RANDOM_BALLS_SMALL])
    def test_matches_brute_force_on_preset(self, preset):
        scene = Scene(preset).build()
        bvh = build_bvh(scene)
        cam = jnp.asarray(default_camera(64, 48).ray_params())
        o, d = raygen(cam, jax.random.PRNGKey(0), 64, 48, False)
        hb = intersect_scene(scene, o, d, T_MIN, T_MAX, 64)
        ht = bvh_intersect_scene(scene, bvh, o, d, T_MIN, T_MAX)
        np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(ht.hit))
        np.testing.assert_array_equal(np.asarray(hb.kind), np.asarray(ht.kind))
        np.testing.assert_array_equal(np.asarray(hb.idx), np.asarray(ht.idx))
        # The two intersectors use algebraically-equivalent but
        # differently-associated f32 quadratics; tolerate rounding.
        np.testing.assert_allclose(np.asarray(hb.t)[np.asarray(hb.hit)],
                                   np.asarray(ht.t)[np.asarray(ht.hit)],
                                   rtol=1e-4)
        np.testing.assert_allclose(np.asarray(hb.normal), np.asarray(ht.normal),
                                   atol=1e-3)

    def test_matches_brute_force_random_rays_and_scene(self):
        scene = random_sphere_scene(137).build()
        bvh = build_bvh(scene)
        rng = np.random.RandomState(5)
        o = jnp.asarray(rng.uniform(-25, 25, (512, 3)), jnp.float32)
        d = rng.normal(size=(512, 3))
        d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
        hb = intersect_scene(scene, o, d, T_MIN, T_MAX, 32)
        ht = bvh_intersect_scene(scene, bvh, o, d, T_MIN, T_MAX)
        np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(ht.hit))
        np.testing.assert_array_equal(np.asarray(hb.idx), np.asarray(ht.idx))
        np.testing.assert_allclose(
            np.where(np.isinf(np.asarray(hb.t)), 0, np.asarray(hb.t)),
            np.where(np.isinf(np.asarray(ht.t)), 0, np.asarray(ht.t)),
            rtol=3e-4)

    def test_rays_from_inside_spheres(self):
        scene = random_sphere_scene(20, spread=5.0).build()
        bvh = build_bvh(scene)
        # origins at sphere centers: back-face hits
        o = scene.sph_center[:20]
        d = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (20, 1))
        hb = intersect_scene(scene, o, d, T_MIN, T_MAX, 8)
        ht = bvh_intersect_scene(scene, bvh, o, d, T_MIN, T_MAX)
        np.testing.assert_array_equal(np.asarray(hb.front), np.asarray(ht.front))
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(ht.t), rtol=1e-4)


class TestBVHEngine:
    def test_engine_bitmatches_megakernel_image(self):
        cfg = RenderConfig(width=48, height=32, max_depth=6, seed=2,
                           intersect_chunk=32, ray_tile=1 << 16)
        imgs = {}
        for engine in ("megakernel", "bvh"):
            scene = Scene(ScenePreset.MATERIAL_TEST)
            film = Film(cfg.width, cfg.height)
            r = create_renderer(engine)
            r.init(film, scene, default_camera(cfg.width, cfg.height), cfg)
            r.progressive_render()
            imgs[engine] = np.asarray(film.hdr_average())
        # f32 rounding in t can flip rare knife-edge dielectric choices;
        # require near-identical images with <1% divergent pixels.
        diff = np.abs(imgs["megakernel"] - imgs["bvh"]).max(axis=-1)
        assert (diff > 1e-3).mean() < 0.01
        np.testing.assert_allclose(imgs["megakernel"].mean(),
                                   imgs["bvh"].mean(), rtol=1e-3)

    def test_mesh_scene_via_bvh(self):
        from parallelraytracing_tpu.core.mesh import icosphere
        mesh = icosphere(1)
        s = Scene(preset=None)
        m = s.add_lambertian((0.8, 0.3, 0.3))
        s.add_mesh(mesh, m, ((1, 1, 1), (0, 0, 0), (0, 1, 0)))
        g = s.add_lambertian((0.5, 0.5, 0.5))
        s.add_quad(20, 20, g, None)
        cfg = RenderConfig(width=48, height=32, max_depth=4, seed=0,
                           intersect_chunk=16, ray_tile=1 << 16)
        film = Film(cfg.width, cfg.height)
        r = create_renderer("bvh")
        r.init(film, s, default_camera(cfg.width, cfg.height), cfg)
        r.progressive_render()
        img = np.asarray(film.hdr_average())
        assert np.isfinite(img).all()
        # the icosahedron must occlude some sky: its red tint shows up
        assert (img[..., 0] > img[..., 2]).any()
