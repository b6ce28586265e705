"""Scene model: builder API, preset scenes, and the flat device representation.

Replaces the reference's pointer-based Scene/MaterialPool/ShapePool/
PrimitiveList (/root/reference/src/core/scene.{h,cpp}, primitive.h,
material.h:163-200, shape.h:107-126).  Where the reference deduplicates and
remaps host pointers into device pointers at upload time
(cuda_megakernel/renderer.cu:276-355, cuda_wavefront/soa.cpp:37-114), we
compile the scene ONCE into flat struct-of-array jnp buffers indexed by
integer ids — the only representation that makes sense for XLA.

Primitives are baked to world space exactly like the reference's OptiX
backend (optix/renderer.cpp:643-671): spheres to world center + scaled
radius, quads to center + half-extent edge vectors + unit normal, triangles
to world-space vertices/normals.  Materials flatten into one table
{type, albedo, roughness, ior, emission} — the analogue of the OptiX
DeviceMaterial (optix/device_types.h:18-25, renderer.cpp:444-486).

All seven presets of the reference are replicated (scene.cpp:42-350),
including the deterministic mt19937(1337) layout of the RANDOM_BALLS
variants (scene.cpp:86).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from parallelraytracing_tpu.config import DEFAULT_SKY
from parallelraytracing_tpu.core import geometry as geo
from parallelraytracing_tpu.core.host_rng import UniformSceneRng

# Material type codes (order matches the reference MatType enum,
# /root/reference/src/core/material_handle.h).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_EMISSIVE = 3

# Primitive kind codes used in hit records.
KIND_NONE = -1
KIND_SPHERE = 0
KIND_QUAD = 1
KIND_TRIANGLE = 2


class ScenePreset(enum.Enum):
    """The reference's preset enum (/root/reference/src/core/scene.h:6-20);
    the default preset there is RANDOM_BALLS_LARGE."""

    DEFAULT = "default"
    LIGHT_TEST = "light_test"
    MATERIAL_TEST = "material_test"
    CORNELL = "cornell"
    RANDOM_BALLS_SMALL = "random_balls_small"
    RANDOM_BALLS_MEDIUM = "random_balls_medium"
    RANDOM_BALLS_LARGE = "random_balls_large"
    #: extension preset (not in the reference): checker floor + material
    #: row at staggered depths — exercises procedural textures in every
    #: engine and reads well with --lens-radius (thin-lens DoF)
    TEXTURE_DEMO = "texture_demo"
    #: extension preset: gradient + analytic-sun sky (Scene.set_sky)
    #: over a mirror/glass sphere field — runs in-kernel in every engine
    SKY_DEMO = "sky_demo"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flat device scene. Every field is a jnp array; the pytree is passed
    straight into jit'd render functions.  Empty categories are padded with
    one inert element and masked via ``*_valid``."""

    # Spheres (world-baked: center = M*origin, radius *= uniform scale).
    sph_center: jax.Array  # (Ns,3) f32
    sph_radius: jax.Array  # (Ns,)  f32
    sph_mat: jax.Array     # (Ns,)  i32
    sph_valid: jax.Array   # (Ns,)  bool

    # Quads (world-baked: center, half-extent edge vectors, unit normal).
    quad_center: jax.Array  # (Nq,3)
    quad_u: jax.Array       # (Nq,3)  center->mid-right edge (half width)
    quad_v: jax.Array       # (Nq,3)  center->mid-top edge (half height)
    quad_normal: jax.Array  # (Nq,3)  unit
    quad_mat: jax.Array     # (Nq,)
    quad_valid: jax.Array   # (Nq,)

    # Triangles (world-baked vertices + shading normals).
    tri_v0: jax.Array  # (Nt,3)
    tri_v1: jax.Array
    tri_v2: jax.Array
    tri_n0: jax.Array
    tri_n1: jax.Array
    tri_n2: jax.Array
    tri_mat: jax.Array    # (Nt,)
    tri_valid: jax.Array  # (Nt,)

    # Material table.
    mat_type: jax.Array    # (Nm,) i32
    mat_albedo: jax.Array  # (Nm,3)
    mat_rough: jax.Array   # (Nm,)
    mat_ior: jax.Array     # (Nm,)
    mat_emit: jax.Array    # (Nm,3)

    # Sky radiance added on ray escape (cuda_megakernel/renderer.cu:159).
    sky: jax.Array  # (3,)

    # --- Sky-model extension (None = the reference's constant sky, and
    # the pytree structure compiles the directional math away).
    # sky_top: horizon->zenith gradient top color (the RTiOW lerp on the
    # normalized ray y; `sky` is then the bottom/horizon color).
    # sun: (9,) = [dir(3, unit), color(3), power, 0, 0] — an analytic sun
    # disc added on top: color * max(dot(d_hat, dir), 0)^power.
    sky_top: Optional[jax.Array] = None  # (3,)
    sun: Optional[jax.Array] = None      # (9,)

    # --- Texture extension (None on untextured scenes, so the pytree
    # STRUCTURE tells jit to elide every texture op for free).  The
    # reference loads mesh texcoords but no material ever samples them
    # (/root/reference/src/core/mesh.cpp:84-104); this activates that
    # dormant channel.  tex codes: 0 = none, 1 = 3D checker (param =
    # [cell scale, odd rgb]), >= 2 = image id (tex - 2) into the atlas.
    mat_tex: Optional[jax.Array] = None        # (Nm,)  i32
    mat_tex_param: Optional[jax.Array] = None  # (Nm,4) f32
    tex_atlas: Optional[jax.Array] = None      # (T,TH,TW,3) f32, padded
    tex_size: Optional[jax.Array] = None       # (T,2)  i32 true (h, w)
    tri_uv0: Optional[jax.Array] = None        # (Nt,2) f32 (image scenes)
    tri_uv1: Optional[jax.Array] = None
    tri_uv2: Optional[jax.Array] = None

    @property
    def num_spheres(self) -> int:
        return int(self.sph_radius.shape[0])

    @property
    def num_quads(self) -> int:
        return int(self.quad_mat.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tri_mat.shape[0])

    @property
    def num_primitives(self) -> int:
        # Counts only valid (non-padding) primitives; pads are created
        # statically so a python int is fine here.
        return (int(np.asarray(self.sph_valid).sum())
                + int(np.asarray(self.quad_valid).sum())
                + int(np.asarray(self.tri_valid).sum()))


TransformSpec = Union[np.ndarray, Tuple, None]


def _resolve_transform(transform: TransformSpec) -> np.ndarray:
    if transform is None:
        return np.eye(4)
    if isinstance(transform, np.ndarray):
        return transform
    scale, euler_deg, translation = transform
    return geo.make_transform(scale, euler_deg, translation)


class Scene:
    """Mutable scene builder; ``build()`` compiles to SceneData.

    API shape mirrors the reference pools (AddLambertian/AddMetal/
    AddDielectric/AddEmissive, AddCircle/AddQuad + AddPrimitive) but returns
    integer ids instead of tagged pointers."""

    def __init__(self, preset: Optional[ScenePreset] = ScenePreset.RANDOM_BALLS_LARGE):
        self._mat_type: List[int] = []
        self._mat_albedo: List[np.ndarray] = []
        self._mat_rough: List[float] = []
        self._mat_ior: List[float] = []
        self._mat_emit: List[np.ndarray] = []
        self._mat_tex: List[int] = []
        self._mat_tex_param: List[np.ndarray] = []
        self._textures: List[np.ndarray] = []  # (H,W,3) f32 images

        self._sph: List[Tuple[np.ndarray, float, int]] = []  # center, radius, mat
        self._quad: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]] = []
        self._tri: List[Tuple] = []  # v0,v1,v2,n0,n1,n2,mat

        # Instanced meshes (TLAS/BLAS path): unique meshes + records of
        # (mesh index, material, 4x4 transform).  NOT baked — geometry
        # memory stays proportional to unique meshes.
        self._inst_meshes: List = []
        self._instances: List[Tuple[int, int, np.ndarray]] = []

        # Set per preset (scene.cpp:65,282,334) but never consumed by the
        # reference backends (they hardcode the sky) — so by default we
        # also ignore it for image fidelity. Set use_sky_intensity=True to
        # honor it (e.g. a truly black sky in CORNELL/LIGHT_TEST).
        self.sky_light_intensity = 1.0
        self.use_sky_intensity = False
        self.sky_color = np.array(DEFAULT_SKY, dtype=np.float64)
        # Sky-model extension (set_sky): None = the reference constant.
        self.sky_top: Optional[np.ndarray] = None
        self.sun_spec: Optional[Tuple[np.ndarray, np.ndarray, int]] = None

        self._cache: Optional[SceneData] = None

        if preset is not None:
            _PRESET_BUILDERS[preset](self)

    # ----------------------------------------------------------------- sky
    def set_sky(self, bottom=None, top=None, sun_direction=None,
                sun_color=None, sun_power: int = 32) -> None:
        """Sky-model extension (the reference hardcodes one constant in
        four places — cpu/renderer.h:31, cuda_megakernel/renderer.cu:159,
        cuda_wavefront/renderer.cu:404, optix/renderer.cpp:41-43):

        - bottom: horizon color (replaces sky_color; alone = constant).
        - top: zenith color — enables the RTiOW-style gradient
          lerp(bottom, top, 0.5*(d_hat.y + 1)).
        - sun_direction/sun_color/sun_power: an analytic sun disc
          color * max(dot(d_hat, dir), 0)^power added on top.  power
          must be a positive int (the trace kernel unrolls it as
          static binary exponentiation).

        Runs in EVERY engine, including in-kernel; scenes that never
        call this compile the directional math away and stay
        bit-identical to the reference semantics."""
        self._cache = None
        if bottom is not None:
            self.sky_color = np.asarray(bottom, dtype=np.float64)
        self.sky_top = (None if top is None
                        else np.asarray(top, dtype=np.float64))
        if sun_direction is not None:
            d = np.asarray(sun_direction, dtype=np.float64)
            n = np.linalg.norm(d)
            if n < 1e-12:
                raise ValueError("set_sky: sun_direction must be non-zero")
            d = d / n
            c = np.asarray(sun_color if sun_color is not None
                           else (1.0, 1.0, 1.0), dtype=np.float64)
            p = int(sun_power)
            assert p >= 1, "sun_power must be a positive integer"
            self.sun_spec = (d, c, p)
        else:
            self.sun_spec = None

    # ------------------------------------------------------------ materials
    def _add_material(self, mtype: int, albedo=(0, 0, 0), rough=0.0,
                      ior=1.0, emit=(0, 0, 0), tex=0,
                      tex_param=(0.0, 0.0, 0.0, 0.0)) -> int:
        self._cache = None
        self._mat_type.append(mtype)
        self._mat_albedo.append(np.asarray(albedo, dtype=np.float64))
        self._mat_rough.append(float(rough))
        self._mat_ior.append(float(ior))
        self._mat_emit.append(np.asarray(emit, dtype=np.float64))
        self._mat_tex.append(int(tex))
        self._mat_tex_param.append(np.asarray(tex_param, dtype=np.float64))
        return len(self._mat_type) - 1

    def add_lambertian(self, albedo) -> int:
        return self._add_material(MAT_LAMBERTIAN, albedo=albedo)

    def add_metal(self, albedo, roughness: float) -> int:
        return self._add_material(MAT_METAL, albedo=albedo, rough=roughness)

    def add_dielectric(self, refraction_index: float) -> int:
        return self._add_material(MAT_DIELECTRIC, ior=refraction_index)

    def add_emissive(self, emission) -> int:
        return self._add_material(MAT_EMISSIVE, emit=emission)

    # Texture extension (no reference analogue — see SceneData docstring).
    def add_checker(self, even, odd, scale: float = 1.0) -> int:
        """Lambertian with a 3D checker albedo: cells of world-space size
        1/scale alternate between `even` and `odd`.  Position-based, so it
        needs no UVs and runs in EVERY engine including the trace
        kernel."""
        odd = np.asarray(odd, dtype=np.float64)
        return self._add_material(
            MAT_LAMBERTIAN, albedo=even, tex=1,
            tex_param=(float(scale), odd[0], odd[1], odd[2]))

    def add_texture(self, image) -> int:
        """Register an (H,W,3) float image; returns a texture id for
        add_textured_lambertian."""
        img = np.asarray(image, dtype=np.float64)
        assert img.ndim == 3 and img.shape[2] == 3, img.shape
        self._cache = None
        self._textures.append(img)
        return len(self._textures) - 1

    def add_textured_lambertian(self, texture_id: int) -> int:
        """Lambertian whose albedo is sampled (bilinear, repeat-wrapped)
        from a registered image texture at the hit's UV.  Supported by
        every engine; the trace kernel fetches texels with per-lane
        gathers."""
        assert 0 <= texture_id < len(self._textures), texture_id
        return self._add_material(MAT_LAMBERTIAN, albedo=(1.0, 1.0, 1.0),
                                  tex=2 + texture_id)

    @property
    def num_materials(self) -> int:
        return len(self._mat_type)

    # ----------------------------------------------------------- primitives
    def add_sphere(self, radius: float, material: int,
                   transform: TransformSpec = None) -> None:
        """Reference 'Circle' shape (shape.h:17-29) baked to world space."""
        self._cache = None
        m = _resolve_transform(transform)
        scale = geo.uniform_scale_of(m)
        center = geo.transform_point(m, (0.0, 0.0, 0.0))
        self._sph.append((center, float(radius) * scale, material))

    def add_quad(self, width: float, height: float, material: int,
                 transform: TransformSpec = None) -> None:
        """Local y=0 plane, x in [-w/2,w/2], z in [-h/2,h/2], normal +Y
        (shape.h:31-47), baked like optix/renderer.cpp:649-671."""
        self._cache = None
        m = _resolve_transform(transform)
        inv = np.linalg.inv(m)
        center = geo.transform_point(m, (0.0, 0.0, 0.0))
        u = geo.transform_point(m, (width / 2.0, 0.0, 0.0)) - center
        v = geo.transform_point(m, (0.0, 0.0, height / 2.0)) - center
        n = geo.transform_normal(inv, (0.0, 1.0, 0.0))
        self._quad.append((center, u, v, n, material))

    def add_triangle(self, v0, v1, v2, n0=None, n1=None, n2=None,
                     material: int = 0, transform: TransformSpec = None,
                     uv0=None, uv1=None, uv2=None) -> None:
        self._cache = None
        m = _resolve_transform(transform)
        inv = np.linalg.inv(m)
        w0 = geo.transform_point(m, v0)
        w1 = geo.transform_point(m, v1)
        w2 = geo.transform_point(m, v2)
        if n0 is None:
            gn = np.cross(w1 - w0, w2 - w0)
            nrm = np.linalg.norm(gn)
            gn = gn / nrm if nrm > 0 else np.array([0.0, 1.0, 0.0])
            wn0 = wn1 = wn2 = gn
        else:
            wn0 = geo.transform_normal(inv, n0)
            wn1 = geo.transform_normal(inv, n1)
            wn2 = geo.transform_normal(inv, n2)
        self._tri.append((w0, w1, w2, wn0, wn1, wn2, material,
                          uv0, uv1, uv2))

    def add_mesh(self, mesh, material: int,
                 transform: TransformSpec = None) -> None:
        """Add every triangle of a Mesh (core/mesh.py) — activates the
        reference's dormant Mesh/Triangle path (mesh.cpp, shape.h:262-303)."""
        self._cache = None
        m = _resolve_transform(transform)
        inv = np.linalg.inv(m)
        verts = np.asarray(mesh.vertices, dtype=np.float64)
        idx = np.asarray(mesh.indices, dtype=np.int64).reshape(-1, 3)
        w = verts @ m[:3, :3].T + m[:3, 3]
        if mesh.normals is not None and len(mesh.normals) == len(verts):
            nrm = np.asarray(mesh.normals, dtype=np.float64) @ inv[:3, :3]
            lens = np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = nrm / np.maximum(lens, 1e-30)
        else:
            nrm = None
        uv = (np.asarray(mesh.texcoords, dtype=np.float64)
              if getattr(mesh, "texcoords", None) is not None
              and len(mesh.texcoords) == len(verts) else None)
        for (a, b, c) in idx:
            uvs = (uv[a], uv[b], uv[c]) if uv is not None else (None,) * 3
            if nrm is not None:
                self._tri.append((w[a], w[b], w[c], nrm[a], nrm[b], nrm[c],
                                  material, *uvs))
            else:
                gn = np.cross(w[b] - w[a], w[c] - w[a])
                ln = np.linalg.norm(gn)
                gn = gn / ln if ln > 0 else np.array([0.0, 1.0, 0.0])
                self._tri.append((w[a], w[b], w[c], gn, gn, gn,
                                  material, *uvs))

    def add_mesh_instances(self, mesh, material: int,
                           transforms: Sequence[TransformSpec]) -> None:
        """Instance a mesh under several transforms (the role of the
        reference's OptiX IAS, optix/renderer.cpp:833-870).

        Instances are stored as {mesh, material, transform} records — NOT
        baked, so memory is proportional to unique meshes.  The two-level
        traversal (accel/tlas.py, engine "tlas") consumes them natively;
        flat engines get a world-baked copy only when build() compiles the
        flat SceneData (documented replication for backends without
        instancing support — the reference's non-OptiX backends have no
        instancing at all)."""
        self._cache = None
        for i, m in enumerate(self._inst_meshes):
            if m is mesh:
                mesh_i = i
                break
        else:
            self._inst_meshes.append(mesh)
            mesh_i = len(self._inst_meshes) - 1
        for t in transforms:
            self._instances.append((mesh_i, material,
                                    _resolve_transform(t)))

    @property
    def num_primitives(self) -> int:
        return len(self._sph) + len(self._quad) + self.num_triangles

    @property
    def num_triangles(self) -> int:
        """Triangles, each instance's counted once per instance."""
        return len(self._tri) + sum(
            len(np.asarray(self._inst_meshes[mi].indices)) // 3
            for mi, _, _ in self._instances)

    @property
    def instances(self):
        return list(self._instances)

    def build_two_level(self, dtype=jnp.float32):
        """Compile for the two-level (TLAS/BLAS) path: returns
        (base SceneData WITHOUT the instanced meshes, TwoLevelBVH or None
        when the scene has no instances)."""
        base = self.build(dtype=dtype, bake_instances=False)
        if not self._instances:
            return base, None
        from parallelraytracing_tpu.accel.tlas import build_two_level
        return base, build_two_level(self._inst_meshes, self._instances,
                                     dtype=dtype)

    def _baked_instance_tris(self) -> List[Tuple]:
        """World-bake the stored instances into triangle records (for flat
        engines without two-level traversal; the TLAS path never calls
        this)."""
        out: List[Tuple] = []
        saved = self._tri
        try:
            self._tri = out
            for mesh_i, mat, m4 in self._instances:
                self.add_mesh(self._inst_meshes[mesh_i], mat, m4)
        finally:
            self._tri = saved
        return out

    # ---------------------------------------------------------------- build
    def build(self, dtype=jnp.float32, bake_instances: bool = True) -> SceneData:
        if bake_instances and self._cache is not None:
            return self._cache

        def f32(x):
            return jnp.asarray(np.asarray(x, dtype=np.float64), dtype=dtype)

        # Spheres (pad one inert if empty).
        sph = self._sph or [(np.array([0.0, 0.0, 0.0]), 0.0, 0)]
        sph_valid = np.array([True] * len(self._sph) or [False])
        sph_center = f32([s[0] for s in sph])
        sph_radius = f32([s[1] for s in sph])
        sph_mat = jnp.asarray([s[2] for s in sph], dtype=jnp.int32)

        quad = self._quad or [(np.zeros(3), np.array([1.0, 0, 0]),
                               np.array([0, 0, 1.0]), np.array([0, 1.0, 0]), 0)]
        quad_valid = np.array([True] * len(self._quad) or [False])
        quad_center = f32([q[0] for q in quad])
        quad_u = f32([q[1] for q in quad])
        quad_v = f32([q[2] for q in quad])
        quad_normal = f32([q[3] for q in quad])
        quad_mat = jnp.asarray([q[4] for q in quad], dtype=jnp.int32)

        tris = self._tri + (self._baked_instance_tris()
                            if bake_instances and self._instances else [])
        tri = tris or [(np.zeros(3), np.zeros(3), np.zeros(3),
                        np.array([0, 1.0, 0]), np.array([0, 1.0, 0]),
                        np.array([0, 1.0, 0]), 0, None, None, None)]
        tri_valid = np.array([True] * len(tris) or [False])
        tri_v0 = f32([t[0] for t in tri])
        tri_v1 = f32([t[1] for t in tri])
        tri_v2 = f32([t[2] for t in tri])
        tri_n0 = f32([t[3] for t in tri])
        tri_n1 = f32([t[4] for t in tri])
        tri_n2 = f32([t[5] for t in tri])
        tri_mat = jnp.asarray([t[6] for t in tri], dtype=jnp.int32)

        mats = self._mat_type or [MAT_LAMBERTIAN]
        if not self._mat_type:
            self._add_material(MAT_LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
            mats = self._mat_type

        # Texture channel: populated ONLY when used, so untextured scenes
        # keep the bare pytree structure (and jit specializes texture ops
        # away entirely).
        tex_kw = {}
        if any(self._mat_tex):
            tex_kw["mat_tex"] = jnp.asarray(self._mat_tex, dtype=jnp.int32)
            tex_kw["mat_tex_param"] = f32(self._mat_tex_param)
        if any(t >= 2 for t in self._mat_tex):
            th = max(t.shape[0] for t in self._textures)
            tw = max(t.shape[1] for t in self._textures)
            atlas = np.zeros((len(self._textures), th, tw, 3))
            size = np.zeros((len(self._textures), 2), np.int64)
            for i, img in enumerate(self._textures):
                atlas[i, :img.shape[0], :img.shape[1]] = img
                size[i] = (img.shape[0], img.shape[1])
            tex_kw["tex_atlas"] = f32(atlas)
            tex_kw["tex_size"] = jnp.asarray(size, dtype=jnp.int32)

            def uv_col(j):
                return f32([np.asarray(t[j], np.float64)
                            if len(t) > j and t[j] is not None
                            else np.zeros(2) for t in tri])
            tex_kw["tri_uv0"] = uv_col(7)
            tex_kw["tri_uv1"] = uv_col(8)
            tex_kw["tri_uv2"] = uv_col(9)

        _sky_scale = (self.sky_light_intensity
                      if self.use_sky_intensity else 1.0)
        data = SceneData(
            sph_center=sph_center, sph_radius=sph_radius, sph_mat=sph_mat,
            sph_valid=jnp.asarray(sph_valid),
            quad_center=quad_center, quad_u=quad_u, quad_v=quad_v,
            quad_normal=quad_normal, quad_mat=quad_mat,
            quad_valid=jnp.asarray(quad_valid),
            tri_v0=tri_v0, tri_v1=tri_v1, tri_v2=tri_v2,
            tri_n0=tri_n0, tri_n1=tri_n1, tri_n2=tri_n2,
            tri_mat=tri_mat, tri_valid=jnp.asarray(tri_valid),
            mat_type=jnp.asarray(mats, dtype=jnp.int32),
            mat_albedo=f32(self._mat_albedo),
            mat_rough=f32(self._mat_rough),
            mat_ior=f32(self._mat_ior),
            mat_emit=f32(self._mat_emit),
            # The intensity quirk (scene.h:61, never consumed by the
            # reference) scales the WHOLE sky model uniformly.
            sky=f32(self.sky_color * _sky_scale),
            sky_top=(None if self.sky_top is None
                     else f32(self.sky_top * _sky_scale)),
            sun=(None if self.sun_spec is None else f32(np.concatenate([
                self.sun_spec[0], self.sun_spec[1] * _sky_scale,
                [float(self.sun_spec[2]), 0.0, 0.0]]))),
            **tex_kw,
        )
        if bake_instances:
            self._cache = data
        return data


# ----------------------------------------------------------------------------
# Presets — line-by-line behavioral replicas of scene.cpp:62-350.
# ----------------------------------------------------------------------------

def _t(scale, euler, trans):
    return geo.make_transform(scale, euler, trans)


def _init_random_balls(scene: Scene, ball_count: int) -> None:
    """scene.cpp:62-170 (ground quad + N random balls + 8 emissive)."""
    scene.sky_light_intensity = 1.0
    ground = scene.add_lambertian((0.5, 0.5, 0.5))
    scene.add_quad(200.0, 200.0, ground, None)

    rng = UniformSceneRng(1337)  # scene.cpp:86

    for _ in range(ball_count):
        radius = rng.uniform(0.2, 1.0)
        pos = (rng.uniform(-40.0, 40.0), radius, rng.uniform(-40.0, 40.0))
        # NOTE draw order matters: reference draws radius, then pos.x, pos.z
        # interleaved with construction; glm vec3(x, radius, z) evaluates
        # distPos twice after distRadius — we matched that order above.
        m = rng.uniform()
        if m < 0.65:
            mat = scene.add_lambertian((rng.uniform(), rng.uniform(), rng.uniform()))
        elif m < 0.9:
            g = 0.7 + 0.3 * rng.uniform()
            mat = scene.add_metal((g, g, g), 0.05 * rng.uniform())
        else:
            mat = scene.add_dielectric(1.3 + 0.4 * rng.uniform())
        scene.add_sphere(radius, mat, _t((1, 1, 1), (0, 0, 0), pos))

    for _ in range(8):
        pos = (rng.uniform(-40.0, 40.0), 8.0, rng.uniform(-40.0, 40.0))
        e = 10.0 + 10.0 * rng.uniform()
        mat = scene.add_emissive((e, e, e))
        scene.add_sphere(1.5, mat, _t((1, 1, 1), (0, 0, 0), pos))


def _init_default(scene: Scene) -> None:
    """scene.cpp:188-278."""
    em = scene.add_emissive((10, 5, 5))
    scene.add_sphere(1.0, em, _t((2, 2, 2), (0, 0, 0), (5, 6, 0)))

    qe = scene.add_emissive((3, 4, 2))
    scene.add_quad(8, 8, qe, _t((1, 1, 1), (50, 0, 0), (-4, 7, 7)))
    qe2 = scene.add_emissive((3, 2, 1))
    scene.add_quad(8, 8, qe2, _t((1, 1, 1), (50, 0, 0), (4, 7, 7)))

    green = scene.add_lambertian((0.2, 1.0, 0.2))
    scene.add_sphere(1.0, green, _t((1, 1, 1), (0, 0, 0), (4, 1, 0)))
    red = scene.add_lambertian((1.0, 0.2, 0.2))
    scene.add_sphere(1.0, red, _t((1, 1, 1), (0, 0, 0), (-4, 1, 0)))
    # Intentional-looking sub-unity IoR in the reference (scene.cpp:246).
    diel = scene.add_dielectric(0.9)
    scene.add_sphere(1.0, diel, _t((1, 1, 1), (0, 0, 0), (0, 1, 4)))
    metal = scene.add_metal((1.0, 0.7, 0.8), 0.01)
    scene.add_sphere(1.0, metal, _t((1, 1, 1), (0, 0, 0), (0, 1, -4)))
    ground = scene.add_lambertian((0.7, 0.7, 0.4))
    scene.add_quad(20, 20, ground, None)


def _init_light_test(scene: Scene) -> None:
    """scene.cpp:280-305 (emissive-only lighting; sky intensity 0)."""
    scene.sky_light_intensity = 0.0
    ground = scene.add_lambertian((0.6, 0.6, 0.6))
    scene.add_quad(30, 30, ground, None)
    for i in range(-5, 6):
        mat = scene.add_emissive((4, 4, 4))
        scene.add_sphere(0.5, mat, _t((1, 1, 1), (0, 0, 0), (i * 2.0, 6, 0)))


def _init_material_test(scene: Scene) -> None:
    """scene.cpp:307-330 (one sphere per BSDF over a ground quad)."""
    ground = scene.add_lambertian((0.8, 0.8, 0.8))
    scene.add_quad(25, 25, ground, None)
    scene.add_sphere(1.0, scene.add_lambertian((1, 0, 0)),
                     _t((1, 1, 1), (0, 0, 0), (-4, 1, 0)))
    scene.add_sphere(1.0, scene.add_metal((0.9, 0.9, 0.9), 0.0),
                     _t((1, 1, 1), (0, 0, 0), (0, 1, 0)))
    scene.add_sphere(1.0, scene.add_dielectric(1.5),
                     _t((1, 1, 1), (0, 0, 0), (4, 1, 0)))


def _init_cornell(scene: Scene) -> None:
    """scene.cpp:332-350."""
    scene.sky_light_intensity = 0.0
    red = scene.add_lambertian((0.75, 0.1, 0.1))
    green = scene.add_lambertian((0.1, 0.75, 0.1))
    white = scene.add_lambertian((0.8, 0.8, 0.8))
    scene.add_quad(10, 10, white, None)
    scene.add_quad(10, 10, red, _t((1, 1, 1), (90, 0, 0), (-5, 5, 0)))
    scene.add_quad(10, 10, green, _t((1, 1, 1), (90, 0, 0), (5, 5, 0)))
    light = scene.add_emissive((15, 15, 15))
    scene.add_quad(10, 10, light, _t((1, 1, 1), (90, 0, 0), (0, 9, 0)))


def _init_texture_demo(scene: Scene) -> None:
    """Extension demo (no reference analogue): a checkered ground plane
    with a row of lambertian/metal/dielectric spheres at staggered
    depths — the canonical showcase for Scene.add_checker and thin-lens
    depth of field (RenderConfig.lens_radius)."""
    floor = scene.add_checker((0.85, 0.85, 0.85), (0.12, 0.15, 0.2),
                              scale=0.8)
    scene.add_quad(60, 60, floor, None)
    mirror = scene.add_metal((0.9, 0.9, 0.95), 0.02)
    glass = scene.add_dielectric(1.5)
    for i, z in enumerate((-6.0, -2.0, 2.0, 6.0)):
        tint = scene.add_lambertian((0.8, 0.25 + 0.15 * i, 0.2))
        scene.add_sphere(1.0, tint, ((1, 1, 1), (0, 0, 0), (-2.5, 1.0, z)))
        scene.add_sphere(1.0, mirror if i % 2 else glass,
                         ((1, 1, 1), (0, 0, 0), (2.5, 1.0, z)))
    light = scene.add_emissive((6, 6, 6))
    scene.add_sphere(2.0, light, ((1, 1, 1), (0, 0, 0), (0.0, 12.0, 0.0)))
    # An IMAGE texture (32x32 procedural plaid) on a tilted back-wall
    # quad.
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    img = np.stack([
        0.15 + 0.8 * ((xx // 8 + yy // 8) % 2),
        0.2 + 0.6 * np.abs(np.sin(xx * 0.4)),
        0.25 + 0.7 * (yy / 31.0)], axis=2)
    wall = scene.add_textured_lambertian(scene.add_texture(img))
    scene.add_quad(6, 4, wall, ((1, 1, 1), (90, 0, 0), (0.0, 4.0, -9.0)))
    # An image-textured SPHERE (procedural latitude-band globe): the
    # equirect UV from the hit's direction to the center.
    gy, gx = np.meshgrid(np.arange(48), np.arange(96), indexing="ij")
    globe = np.stack([
        0.2 + 0.6 * (np.sin(gy * np.pi / 12.0) > 0),
        0.3 + 0.5 * ((gx // 12) % 2),
        0.7 - 0.5 * np.abs(gy / 47.0 - 0.5) * 2.0], axis=2)
    ball = scene.add_textured_lambertian(scene.add_texture(globe))
    scene.add_sphere(1.4, ball, ((1, 1, 1), (0, 25, 0), (0.0, 1.4, -4.0)))


def _init_sky_demo(scene: Scene) -> None:
    """Extension demo (no reference analogue): the RTiOW gradient sky
    plus an analytic sun disc (Scene.set_sky) lighting a mirror/glass
    sphere field on a soft-gray floor — specular paths pick the sun up
    as sharp highlights while diffuse surfaces read the gradient."""
    scene.set_sky(bottom=(1.0, 1.0, 1.0), top=(0.35, 0.55, 0.95),
                  sun_direction=(0.45, 0.65, 0.35),
                  sun_color=(14.0, 12.0, 9.0), sun_power=256)
    ground = scene.add_lambertian((0.55, 0.55, 0.55))
    scene.add_quad(80, 80, ground, None)
    mirror = scene.add_metal((0.95, 0.95, 0.95), 0.02)
    brushed = scene.add_metal((0.8, 0.65, 0.4), 0.25)
    glass = scene.add_dielectric(1.5)
    scene.add_sphere(2.0, mirror, ((1, 1, 1), (0, 0, 0), (-4.5, 2.0, 0)))
    scene.add_sphere(2.0, glass, ((1, 1, 1), (0, 0, 0), (0.0, 2.0, 1.5)))
    scene.add_sphere(2.0, brushed, ((1, 1, 1), (0, 0, 0), (4.5, 2.0, 0)))
    for i in range(6):
        tint = scene.add_lambertian((0.25 + 0.1 * i, 0.4, 0.7 - 0.08 * i))
        scene.add_sphere(0.7, tint,
                         ((1, 1, 1), (0, 0, 0),
                          (-5.0 + 2.0 * i, 0.7, 4.5)))


_PRESET_BUILDERS = {
    ScenePreset.DEFAULT: _init_default,
    ScenePreset.LIGHT_TEST: _init_light_test,
    ScenePreset.MATERIAL_TEST: _init_material_test,
    ScenePreset.CORNELL: _init_cornell,
    ScenePreset.RANDOM_BALLS_SMALL: lambda s: _init_random_balls(s, 100),
    ScenePreset.RANDOM_BALLS_MEDIUM: lambda s: _init_random_balls(s, 400),
    ScenePreset.RANDOM_BALLS_LARGE: lambda s: _init_random_balls(s, 800),
    ScenePreset.TEXTURE_DEMO: _init_texture_demo,
    ScenePreset.SKY_DEMO: _init_sky_demo,
}


def mesh_showcase_scene(mesh):
    """The shared mesh showcase: the mesh (scaled 8x, turned to face the
    camera) on a gray ground quad under an emissive sphere, with the
    camera framing used by the CLI/viewer/benchmarks.  Returns (scene,
    eye, look_at)."""
    scene = Scene(preset=None)
    mat = scene.add_lambertian((0.75, 0.65, 0.5))
    scene.add_mesh(mesh, mat, ((8, 8, 8), (0, 180, 0), (0, 8, 0)))
    ground = scene.add_lambertian((0.5, 0.5, 0.5))
    scene.add_quad(100, 100, ground, None)
    light = scene.add_emissive((12, 12, 12))
    scene.add_sphere(3.0, light, ((1, 1, 1), (0, 0, 0), (12, 25, 12)))
    return scene, (0.0, 14.0, 28.0), (0.0, 7.0, 0.0)


def procedural_mesh_scene(level: int, seed: int = 0):
    """mesh_showcase_scene of the seeded icosphere (core/mesh.icosphere:
    20 * 4**level triangles)."""
    from parallelraytracing_tpu.core.mesh import icosphere
    return mesh_showcase_scene(icosphere(level, seed))


def ply_showcase_scene(path: str):
    """mesh_showcase_scene of a PLY file, so `cli --ply` and `viewer
    --ply` render the same image for the same file (the reference's Mesh
    path was dormant — mesh.cpp is never instantiated)."""
    from parallelraytracing_tpu.core.mesh import load_ply
    return mesh_showcase_scene(load_ply(path))
