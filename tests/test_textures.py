"""Texture extension: 3D checker + UV image textures, in every engine.

The reference loads mesh texcoords but never samples them
(/root/reference/src/core/mesh.cpp:84-104); this framework activates the
channel.  Load-bearing properties:

- untextured scenes keep a texture-free pytree (mat_tex is None) so
  every existing golden stays bit-identical — covered by test_golden;
- the checker is position-based and must agree between the jnp oracle
  and the trace kernel (statistically), with fused == wavefront_fused
  bit-exact;
- image sampling is bilinear with repeat wrap, exact at texel centers;
- the trace kernel fetches texels with per-lane gathers, so image
  textures of any size render in-kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallelraytracing_tpu import (Film, RenderConfig, Scene, ScenePreset,
                                    create_renderer)
from parallelraytracing_tpu.core.camera import Camera
from parallelraytracing_tpu.ops.textures import checker_weight, sample_atlas

pytestmark = pytest.mark.slow  # kernel interpret texture renders

CFG = RenderConfig(width=64, height=32, max_depth=4, seed=1,
                   intersect_chunk=32, ray_tile=1 << 16)


def checker_scene():
    s = Scene(None)
    chk = s.add_checker((0.9, 0.9, 0.9), (0.1, 0.1, 0.1), scale=1.0)
    s.add_quad(20.0, 20.0, chk, ((1, 1, 1), (0, 0, 0), (0, 0, 0)))
    glow = s.add_emissive((3.0, 3.0, 3.0))
    s.add_sphere(1.0, glow, ((1, 1, 1), (0, 0, 0), (0.0, 2.0, 0.0)))
    return s


def quadrant_image():
    img = np.zeros((2, 2, 3))
    img[0, 0] = (1, 0, 0)   # uv (0..0.5, 0.5..1): v=1 is row 0
    img[0, 1] = (0, 1, 0)
    img[1, 0] = (0, 0, 1)
    img[1, 1] = (1, 1, 0)
    return img


def image_scene():
    s = Scene(None)
    tid = s.add_texture(quadrant_image())
    m = s.add_textured_lambertian(tid)
    s.add_quad(8.0, 8.0, m, ((1, 1, 1), (0, 0, 0), (0, 0, 0)))
    glow = s.add_emissive((4.0, 4.0, 4.0))
    s.add_sphere(1.0, glow, ((1, 1, 1), (0, 0, 0), (0.0, 4.0, 0.0)))
    return s


def render(engine, scene, cam, cfg=CFG, frames=6, **attrs):
    film = Film(cfg.width, cfg.height)
    r = create_renderer(engine)
    if hasattr(r, "interpret"):  # a kernel engine
        r.interpret = True
    for k, v in attrs.items():
        setattr(r, k, v)
    r.init(film, scene, cam, cfg)
    for _ in range(frames):
        r.progressive_render()
    return np.asarray(film.hdr_average())


CAM = Camera((6.0, 6.0, 9.0), (-6.0, -5.5, -9.0), 64, 32)


def test_checker_weight_cells():
    # Lattice is offset by CHECKER_OFFSET (1/pi), so cell k spans
    # [(k - off)/scale, (k+1 - off)/scale).
    pos = jnp.asarray([[0.5, 0.5, 0.5],    # cells (0,0,0) -> even
                       [1.5, 0.5, 0.5],    # (1,0,0) -> odd
                       [1.5, 1.5, 0.5],    # (1,1,0) -> even
                       [-0.5, 0.5, 0.5]])  # (-1,0,0) -> odd
    w = np.asarray(checker_weight(pos, jnp.ones(4)))
    assert list(w) == [0.0, 1.0, 0.0, 1.0]
    # cell size scales as 1/scale (all four collapse into cell 0 at 1/4)
    w2 = np.asarray(checker_weight(pos, jnp.full(4, 0.25)))
    assert list(w2) == [0.0, 0.0, 0.0, 0.0]
    # an exact y=0 plane must NOT sit on a cell boundary: tiny float
    # jitter around 0 stays in ONE cell (the aliasing regression)
    eps = jnp.asarray([[3.0, -1e-6, 3.0], [3.0, 1e-6, 3.0]])
    we = np.asarray(checker_weight(eps, jnp.ones(2)))
    assert we[0] == we[1]


def test_sample_atlas_exact_at_texel_centers():
    img = quadrant_image()
    atlas = jnp.asarray(img, jnp.float32)[None]
    size = jnp.asarray([[2, 2]], jnp.int32)
    tid = jnp.zeros(4, jnp.int32)
    # texel centers: u in {0.25, 0.75}, v in {0.75, 0.25} (v up)
    uv = jnp.asarray([[0.25, 0.75], [0.75, 0.75],
                      [0.25, 0.25], [0.75, 0.25]], jnp.float32)
    got = np.asarray(sample_atlas(atlas, size, tid, uv))
    want = np.stack([img[0, 0], img[0, 1], img[1, 0], img[1, 1]])
    np.testing.assert_allclose(got, want, atol=1e-6)
    # repeat wrap: uv + integer offsets sample the same texels
    got2 = np.asarray(sample_atlas(atlas, size, tid,
                                   uv + jnp.asarray([[2.0, -3.0]])))
    np.testing.assert_allclose(got2, want, atol=1e-5)


def test_checker_runs_in_every_engine_and_agrees():
    a = render("megakernel", checker_scene(), CAM, frames=8)
    b = render("fused", checker_scene(), CAM, frames=8)
    c = render("wavefront_fused", checker_scene(), CAM, frames=8, schedule=(2,))
    w = render("wavefront", checker_scene(), CAM, frames=8)
    assert np.array_equal(b, c), "checker broke fused==wavefront_fused"
    assert np.array_equal(a, w), "checker broke megakernel==wavefront"
    assert abs(a.mean() - b.mean()) / a.mean() < 0.03
    # the checker is actually visible: odd cells darker than even
    assert a.std() > 0.05


def test_checker_is_a_real_checker():
    # Top-down view of the checker floor: neighboring world cells differ.
    cam = Camera((0.0, 10.0, 0.01), (0.0, -1.0, -0.001), 64, 32)
    im = render("megakernel", checker_scene(), cam, frames=12) \
        .reshape(32, 64, 3)
    mid = im[16]
    bright = mid.sum(axis=1) > np.median(mid.sum(axis=1))
    # runs of bright/dark alternate — more than 4 transitions across a row
    assert np.abs(np.diff(bright.astype(int))).sum() >= 4


def test_image_texture_quadrants():
    cam = Camera((0.0, 8.0, 0.01), (0.0, -1.0, -0.001), 64, 32)
    im = render("megakernel", image_scene(), cam, frames=10) \
        .reshape(32, 64, 3)
    # Camera looks straight down at the quad; each image quadrant should
    # be dominated by its texture color channel(s).
    h, w = 32, 64
    quads = {
        "tl": im[2:h // 2 - 2, 18:w // 2 - 2].mean(axis=(0, 1)),
        "tr": im[2:h // 2 - 2, w // 2 + 2:46].mean(axis=(0, 1)),
        "bl": im[h // 2 + 2:h - 2, 18:w // 2 - 2].mean(axis=(0, 1)),
        "br": im[h // 2 + 2:h - 2, w // 2 + 2:46].mean(axis=(0, 1)),
    }
    # the quadrants carry distinct texture colors through the ambient
    # wash: red-, green- and blue-dominant regions all present, and they
    # sit where the uv mapping puts them (bl=red, br=green, tl=blue).
    doms = {k: int(np.argmax(v)) for k, v in quads.items()}
    assert {0, 1, 2} <= set(doms.values()), (doms, quads)
    assert doms["tl"] == 2 and doms["bl"] == 0 and doms["br"] == 1, doms


def test_image_jnp_engines_agree():
    cam = Camera((0.0, 8.0, 0.01), (0.0, -1.0, -0.001), 64, 32)
    imgs = [render(e, image_scene(), cam, frames=3)
            for e in ("megakernel", "wavefront", "bvh", "wavefront_bvh")]
    # bvh shares the oracle's program shape: bit-exact; the wavefront
    # loop's differently-fused bilinear sample drifts by <= 1 ulp on CPU
    # XLA, so those compare with a 1-ulp tolerance.
    assert np.array_equal(imgs[0], imgs[2])
    for other in imgs[1:]:
        np.testing.assert_allclose(imgs[0], other, atol=2e-7)


def test_pallas_engines_render_small_image_textures():
    # image textures run in-kernel (per-lane texel gathers,
    # ops/trace_kernel.pack_textures)
    cam = Camera((0.0, 8.0, 0.01), (0.0, -1.0, -0.001), 64, 32)
    b = render("fused", image_scene(), cam, frames=10)
    c = render("wavefront_fused", image_scene(), cam, frames=10, schedule=(2,))
    # the shared-PCG contract survives texturing
    assert np.array_equal(b, c), "image tex broke fused==wavefront_fused"
    # the quadrants land where the uv mapping puts them (cf. the
    # megakernel quadrant test): bl=red, br=green, tl=blue
    im = b.reshape(32, 64, 3)
    h, w = 32, 64
    doms = {
        "tl": int(np.argmax(im[2:h // 2 - 2, 18:w // 2 - 2]
                            .mean(axis=(0, 1)))),
        "bl": int(np.argmax(im[h // 2 + 2:h - 2, 18:w // 2 - 2]
                            .mean(axis=(0, 1)))),
        "br": int(np.argmax(im[h // 2 + 2:h - 2, w // 2 + 2:46]
                            .mean(axis=(0, 1)))),
    }
    assert doms["tl"] == 2 and doms["bl"] == 0 and doms["br"] == 1, doms


def test_pallas_image_matches_oracle_statistically():
    # Same scene, same spp: the in-kernel bilinear fetch must agree with
    # the jnp atlas path up to MC noise.
    cam = Camera((0.0, 8.0, 0.01), (0.0, -1.0, -0.001), 64, 32)
    a = render("megakernel", image_scene(), cam, frames=24)
    b = render("fused", image_scene(), cam, frames=24)
    assert abs(a.mean() - b.mean()) / a.mean() < 0.05
    assert float(np.sqrt(np.mean((a - b) ** 2))) < 0.12


def test_kernel_engines_render_large_textures():
    # a texel fetch is a plain gather: a 256x256 texture renders in the
    # kernel engines like a small one (its texel table holds 65,536 rows)
    s = Scene(None)
    yy, xx = np.mgrid[0:256, 0:256]
    big = np.stack([xx / 255.0, yy / 255.0, 0.5 + 0 * xx], axis=-1)
    m = s.add_textured_lambertian(s.add_texture(big))
    s.add_quad(8.0, 8.0, m, ((1, 1, 1), (0, 0, 0), (0, 0, 0)))
    film = Film(CFG.width, CFG.height)
    r = create_renderer("fused")
    r.interpret = True  # Triton interpret mode on CPU
    r.init(film, s, CAM, CFG)
    assert r._tables.tex.shape == (256 * 256, 4)
    r.progressive_render()
    img = np.asarray(film.hdr_average())
    assert np.isfinite(img).all() and img.max() > 0.0


def test_pallas_textured_sphere_matches_oracle():
    # image-textured SPHERES run in-kernel (equirect UV from the hit's
    # direction to the center, arctan2/arcsin).  Same estimator, different RNG
    # stream: statistical agreement with the jnp oracle, and the
    # fused == wavefront_fused bit contract survives.
    def sphere_scene():
        s = Scene(None)
        tid = s.add_texture(quadrant_image())
        m = s.add_textured_lambertian(tid)
        s.add_sphere(2.0, m, ((1, 1, 1), (0, 0, 0), (0, 2, 0)))
        g = s.add_lambertian((0.4, 0.4, 0.4))
        s.add_quad(20.0, 20.0, g, None)
        glow = s.add_emissive((4.0, 4.0, 4.0))
        s.add_sphere(1.0, glow, ((1, 1, 1), (0, 0, 0), (4.0, 6.0, 4.0)))
        return s

    cam = Camera((0.0, 3.0, 8.0), (0.0, -1.0, -8.0), 64, 32)
    a = render("megakernel", sphere_scene(), cam, frames=24)
    b = render("fused", sphere_scene(), cam, frames=24)
    c = render("wavefront_fused", sphere_scene(), cam, frames=24, schedule=(2,))
    assert np.array_equal(b, c), "textured sphere broke fused==wf_fused"
    assert abs(a.mean() - b.mean()) / a.mean() < 0.05
    assert float(np.sqrt(np.mean((a - b) ** 2))) < 0.12
    # the texture actually varies over the sphere (not a flat albedo)
    im = b.reshape(32, 64, 3)
    sphere_px = im[8:24, 24:40]
    assert sphere_px.std() > 0.02


def test_tlas_ref_refuses_image_textures_on_instances():
    # the jnp TLAS MIRROR still refuses (its TwoLevelBVH carries no
    # uvs); the KERNEL tlas path renders them since r5 — next test
    from parallelraytracing_tpu.core.mesh import Mesh
    s = image_scene()
    tri = Mesh(vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1.0]]),
               indices=np.array([0, 1, 2]))
    s.add_mesh_instances(tri, 1, [((1, 1, 1), (0, 0, 0), (0, 3, 0))])
    film = Film(CFG.width, CFG.height)
    r = create_renderer("tlas_ref")  # the jnp mirror traces instances
    with pytest.raises(NotImplementedError, match="instanced"):
        r.init(film, s, CAM, CFG)


def test_pallas_textured_instances_match_baked_oracle():
    # r5 (VERDICT r4 item 5): image textures on INSTANCED mesh
    # materials run in-kernel — itri rows 25-30 carry the mesh
    # texcoords through the BLAS walk (pack_instance_tables with_uv).
    # Oracle: the megakernel with the same instances world-BAKED
    # (Scene.build bake_instances=True propagates texcoords).
    from parallelraytracing_tpu.core.mesh import Mesh

    def make(instanced):
        verts = np.array([[0, 0, 0], [4, 0, 0], [4, 0, 4], [0, 0, 4.0]])
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1.0]])
        mesh = Mesh(vertices=verts, indices=np.array([0, 1, 2, 0, 2, 3]),
                    texcoords=uvs)
        s = Scene(None)
        tid = s.add_texture(quadrant_image())
        m = s.add_textured_lambertian(tid)
        tf = ((1, 1, 1), (0, 0, 0), (-2.0, 0.0, -2.0))
        if instanced:
            s.add_mesh_instances(mesh, m, [tf])
        else:
            s.add_mesh(mesh, m, tf)
        glow = s.add_emissive((4.0, 4.0, 4.0))
        s.add_sphere(0.5, glow, ((1, 1, 1), (0, 0, 0), (0.0, 4.0, 0.0)))
        return s

    cam = Camera((0.0, 6.0, 0.01), (0.0, -1.0, -0.002), 64, 32)
    a = render("megakernel", make(True), cam, frames=24)
    b = render("fused", make(True), cam, frames=24)
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.05
    assert float(np.sqrt(np.mean((a - b) ** 2))) < 0.12
    # and the instanced kernel image matches the flat-baked kernel one
    c = render("fused", make(False), cam, frames=24)
    assert abs(b.mean() - c.mean()) / max(c.mean(), 1e-6) < 0.05


def test_mesh_uvs_flow_from_texcoords():
    from parallelraytracing_tpu.core.mesh import Mesh
    # Two triangles forming a unit quad in xz, uv = (x, z).
    verts = np.array([[0, 0, 0], [4, 0, 0], [4, 0, 4], [0, 0, 4.0]])
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1.0]])
    mesh = Mesh(vertices=verts, indices=np.array([0, 1, 2, 0, 2, 3]),
                texcoords=uvs)
    s = Scene(None)
    tid = s.add_texture(quadrant_image())
    m = s.add_textured_lambertian(tid)
    s.add_mesh(mesh, m)
    glow = s.add_emissive((4.0, 4.0, 4.0))
    s.add_sphere(0.5, glow, ((1, 1, 1), (0, 0, 0), (2.0, 4.0, 2.0)))
    cam = Camera((2.0, 6.0, 2.01), (0.0, -1.0, -0.002), 64, 32)
    im = render("megakernel", s, cam, frames=8).reshape(32, 64, 3)
    assert np.isfinite(im).all()
    # the mesh is textured: red/green/blue/yellow regions all appear
    sums = im.reshape(-1, 3)
    lit = sums[sums.sum(axis=1) > 0.05]
    assert len(lit) > 100
    dom = np.argmax(lit, axis=1)
    assert len(set(dom.tolist())) >= 2
