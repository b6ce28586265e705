"""Abstract renderer contract.

The analogue of the reference Renderer interface
(/root/reference/src/core/renderer.h:8-16): Init / ProgressiveRender /
SetCamera, driven by the frame loop (main.cpp:497-541).  Engines are
registered by name and interchangeable at runtime, like the viewer's
backend radio buttons (main.cpp:152-166,476-485)."""

from __future__ import annotations

import abc
from typing import Dict, Optional, Type

import jax
import numpy as np

from parallelraytracing_tpu.config import RenderConfig
from parallelraytracing_tpu.core.camera import Camera
from parallelraytracing_tpu.core.film import Film
from parallelraytracing_tpu.core.scene import Scene, SceneData


class Renderer(abc.ABC):
    """One progressive sample pass per `progressive_render()` call."""

    name: str = "base"
    #: init keeps a world-space copy of every instance's triangles in
    #: the device scene; engines that trace instances in mesh-local space
    #: (the trace kernel's TLAS/BLAS) turn this off
    bake_instances: bool = True

    def __init__(self) -> None:
        self._film: Optional[Film] = None
        self._scene_data: Optional[SceneData] = None
        self._cam_params: Optional[jax.Array] = None
        self._config: Optional[RenderConfig] = None
        self._frame_index: int = 0

    # ----------------------------------------------------------- lifecycle
    def init(self, film: Film, scene: Scene, camera: Camera,
             config: Optional[RenderConfig] = None) -> None:
        """Renderer::Init (renderer.h:11). Uploads the compiled scene once
        (the analogue of the dedup/remap scene upload,
        cuda_megakernel/renderer.cu:276-355)."""
        self._film = film
        self._config = config or RenderConfig(width=film.width, height=film.height)
        self._scene = scene
        self._scene_data = jax.device_put(
            scene.build(bake_instances=self.bake_instances))
        # QMC camera sampling (cfg.qmc): the frame-independent
        # Cranley–Patterson rotation seed, shared by every engine so the
        # kernel engines' bit-identity contract survives with QMC on.
        from parallelraytracing_tpu.ops.rays import qmc_rotation_seed
        self._qseed = (qmc_rotation_seed(self._config.seed)
                       if self._config.qmc else None)
        self.set_camera(camera)
        self._frame_index = 0
        self._post_init()
        film.set_layout(self.film_layout())

    def _post_init(self) -> None:
        """Hook for engine-specific setup (e.g. BVH build)."""

    def film_layout(self):
        """Optional engine-preferred Film storage layout (inv, slots) —
        e.g. the sharded engine keeps the film in its padded Morton
        shard order so accumulation stays px-sharded with no per-frame
        gather (core/film.set_layout).  None = canonical (H,W)."""
        return None

    def _qpt(self, frame_index: int, s: int):
        """The (4,) Halton point for sample s of this frame (None unless
        cfg.qmc).  Global sample index = frame*spf + s, so the
        progressive accumulation walks the sequence in order."""
        if self._qseed is None:
            return None
        import jax.numpy as jnp

        from parallelraytracing_tpu.ops.rays import halton_qpt
        g = frame_index * self.config.samples_per_frame + s
        return jnp.asarray(halton_qpt(g))

    def set_camera(self, camera: Camera) -> None:
        """Renderer::SetCamera (renderer.h:14); cheap param upload, the
        memcpy-camera analogue (cuda_megakernel/renderer.cu:267-274)."""
        self._camera = camera
        self._cam_params = jax.device_put(camera.ray_params())

    def reset_progressive(self) -> None:
        """Called when the film is cleared (camera moved)."""
        self._frame_index = 0

    # ------------------------------------------------------------- render
    def progressive_render(self) -> None:
        """Render one progressive pass and accumulate it into the film
        (Renderer::ProgressiveRender, renderer.h:13)."""
        assert self._film is not None, "init() first"
        cfg = self._config
        rgb = self.render_sample_buffer(self._frame_index)
        if cfg.firefly_clamp > 0.0:
            import jax.numpy as jnp
            rgb = jnp.minimum(rgb, cfg.firefly_clamp)
        self._film.add_sample_buffer(rgb, float(cfg.samples_per_frame))
        self._frame_index += 1

    @abc.abstractmethod
    def render_sample_buffer(self, frame_index: int) -> jax.Array:
        """Return the (H*W,3) mean radiance of `samples_per_frame` fresh
        samples for this frame (the deviceBuffer the reference feeds to
        Film::AddSampleBufferGPU)."""

    # -------------------------------------------------------------- info
    @property
    def frame_index(self) -> int:
        return self._frame_index

    @property
    def config(self) -> RenderConfig:
        assert self._config is not None
        return self._config


_REGISTRY: Dict[str, Type[Renderer]] = {}


def register_engine(cls: Type[Renderer]) -> Type[Renderer]:
    _REGISTRY[cls.name] = cls
    return cls


def available_engines():
    return sorted(_REGISTRY)


def create_renderer(name: str) -> Renderer:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; available: {available_engines()}")
