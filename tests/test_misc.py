import numpy as np
import pytest

from parallelraytracing_tpu import Film, RenderConfig, Scene, ScenePreset, create_renderer
from parallelraytracing_tpu.core.camera import default_camera
from parallelraytracing_tpu.core.light import add_quad_light, add_sphere_light

pytestmark = pytest.mark.slow  # CLI/e2e renders


def test_light_helpers_and_nee_enumeration():
    from parallelraytracing_tpu.ops.nee import extract_lights
    s = Scene(preset=None)
    add_sphere_light(s, (0, 5, 0), 1.0, (10, 10, 10))
    add_quad_light(s, 4, 4, (3, 2, 1), ((1, 1, 1), (90, 0, 0), (0, 8, 0)))
    d = s.build()
    assert int(np.asarray(d.sph_valid).sum()) == 1
    assert int(np.asarray(d.quad_valid).sum()) == 1
    types = np.asarray(d.mat_type)
    assert (types == 3).sum() == 2  # both emissive
    lights = extract_lights(d)  # the NEE integrator sees both
    assert lights is not None and lights.count == 2


def test_wavefront_fused_bitmatches_fused():
    cfg = RenderConfig(width=32, height=16, max_depth=5, seed=11)
    imgs = {}
    for engine in ("fused", "wavefront_fused"):
        scene = Scene(ScenePreset.DEFAULT)
        film = Film(cfg.width, cfg.height)
        r = create_renderer(engine)
        if hasattr(r, "interpret"):  # a kernel engine
            r.interpret = True
        r.init(film, scene, default_camera(cfg.width, cfg.height), cfg)
        for _ in range(3):
            r.progressive_render()
        imgs[engine] = np.asarray(film.hdr_average())
    np.testing.assert_array_equal(imgs["fused"],
                                  imgs["wavefront_fused"])


def test_mesh_instances_render():
    from parallelraytracing_tpu.core.mesh import icosphere
    mesh = icosphere(0)
    s = Scene(preset=None)
    m = s.add_lambertian((0.9, 0.2, 0.2))
    s.add_mesh_instances(mesh, m, [((1, 1, 1), (0, 0, 0), (x * 3.0, 1, 0))
                                   for x in range(3)])
    g = s.add_lambertian((0.5, 0.5, 0.5))
    s.add_quad(30, 30, g, None)
    cfg = RenderConfig(width=48, height=32, max_depth=4, seed=0,
                       intersect_chunk=32)
    film = Film(cfg.width, cfg.height)
    r = create_renderer("bvh")
    r.init(film, s, default_camera(cfg.width, cfg.height), cfg)
    r.progressive_render()
    img = np.asarray(film.hdr_average())
    assert np.isfinite(img).all()


def test_diagnostics_all_ok():
    from parallelraytracing_tpu.utils.diagnostics import run_diagnostics
    res = run_diagnostics(verbose=False)
    bad = {k: v for k, v in res.items() if not v["ok"]}
    assert not bad, bad


def test_firefly_clamp_caps_radiance():
    cfg = RenderConfig(width=16, height=8, max_depth=4, seed=0,
                       firefly_clamp=0.5)
    scene = Scene(ScenePreset.DEFAULT)  # bright emissives
    film = Film(cfg.width, cfg.height)
    r = create_renderer("megakernel")
    r.init(film, scene, default_camera(cfg.width, cfg.height), cfg)
    r.progressive_render()
    img = np.asarray(film.hdr_average())
    assert img.max() <= 0.5 + 1e-6


def test_film_resize():
    film = Film(4, 2)
    import jax.numpy as jnp
    film.add_sample_buffer(jnp.ones((2, 4, 3)))
    film.resize(8, 6)
    assert film.width == 8 and film.height == 6
    assert film.sample_count == 0
    assert np.asarray(film.accum).shape == (6, 8, 3)


def test_camera_view_projection():
    cam = default_camera(640, 480)
    vp = cam.get_view_projection()
    # the look-at focus (origin) projects to the screen center
    p = vp @ np.array([0.0, 0.0, 0.0, 1.0])
    ndc = p[:3] / p[3]
    assert abs(ndc[0]) < 1e-6 and abs(ndc[1]) < 1e-6
    assert 0.0 < ndc[2] < 1.0  # inside the zero-to-one depth range
    # a point behind the camera lands outside the frustum
    behind = cam.position + cam.front * -5.0
    pb = vp @ np.array([*behind, 1.0])
    assert pb[3] < 0
