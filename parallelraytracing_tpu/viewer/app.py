"""Interactive progressive viewer.

The analogue of the reference's application layer (src/main.cpp): a frame
loop that polls input, integrates the orbit camera, clears the film on
camera movement (main.cpp:506-511), renders one progressive sample, and
displays it — with engine radio-select (main.cpp:476-485) and live
per-stage timing HISTORY graphs (the hand-drawn ImGui plots of
render/film/upload/total/FPS over a 100-frame ring buffer,
main.cpp:177-184,265-462).

Headless accelerator hosts have no OpenGL, so the window is a browser page served
by a stdlib HTTP server: the client drags/wheels the camera (the
GLFW-input analogue, main.cpp:204-263), the server streams the film's
tonemapped PNG.  PNG encoding uses the native encoder
(native/src/imageio.cpp) when built and runs on its OWN thread, so the
render loop never waits on compression (the reference's analogous split:
CUDA renders while GL uploads).  Zero third-party dependencies.

Run:  python -m parallelraytracing_tpu.viewer.app --scene cornell --port 7860
"""

from __future__ import annotations

import argparse
import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><title>parallelraytracing_tpu viewer</title>
<style>
 body { background:#14171c; color:#cfd8e3; font-family:monospace; margin:0; }
 #wrap { display:flex; }
 #img { image-rendering:pixelated; cursor:grab; }
 #panel { padding:12px; min-width:300px; }
 .stat { margin:2px 0; }
 label { display:block; margin:2px 0; }
 canvas { background:#0b0d10; display:block; margin:4px 0; }
 .leg { font-size:11px; }
</style></head>
<body><div id="wrap">
<img id="img" width="__W__" height="__H__"/>
<div id="panel">
 <h3>parallelraytracing_tpu</h3>
 <div id="engines"></div>
 <label><input type="checkbox" id="dn"/> denoise (a-trous x4)</label>
 <hr/>
 <div class="stat">frame: <span id="frame">0</span></div>
 <div class="stat">samples: <span id="samples">0</span></div>
 <div class="stat">render ms: <span id="ms">0</span></div>
 <div class="stat">fps: <span id="fps">0</span></div>
 <hr/>
 <div class="leg"><span style="color:#6fb3ff">render</span> &middot;
  <span style="color:#ffd166">tonemap</span> &middot;
  <span style="color:#ef6f6c">encode</span> (ms, 100-frame history)</div>
 <canvas id="stages" width="280" height="90"></canvas>
 <div class="leg"><span style="color:#9be07f">fps</span></div>
 <canvas id="fpsg" width="280" height="60"></canvas>
 <hr/>
 <div>drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</div>
</div></div>
<script>
const img = document.getElementById('img');
let dragging = false, lastX = 0, lastY = 0;
img.onmousedown = e => { dragging = true; lastX = e.clientX; lastY = e.clientY; };
window.onmouseup = () => dragging = false;
window.onmousemove = e => {
  if (!dragging) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  const kind = e.shiftKey ? 'translate' : 'rotate';
  fetch('/control', {method:'POST', body: JSON.stringify({kind, dx, dy})});
};
document.getElementById('dn').onchange = e =>
  fetch('/control', {method:'POST',
    body: JSON.stringify({kind:'denoise', on: e.target.checked})});
img.onwheel = e => {
  e.preventDefault();
  fetch('/control', {method:'POST',
    body: JSON.stringify({kind:'zoom', dy: e.deltaY})});
};
function plot(canvas, series, colors) {
  const ctx = canvas.getContext('2d');
  const W = canvas.width, H = canvas.height;
  ctx.clearRect(0, 0, W, H);
  let max = 1e-6;
  for (const s of series) for (const v of s) max = Math.max(max, v);
  ctx.strokeStyle = '#2a2f38'; ctx.beginPath();          // grid
  for (let g = 1; g < 4; g++) { ctx.moveTo(0, H*g/4); ctx.lineTo(W, H*g/4); }
  ctx.stroke();
  ctx.fillStyle = '#5a6472'; ctx.font = '10px monospace';
  ctx.fillText(max.toFixed(1), 2, 10);
  series.forEach((s, i) => {
    ctx.strokeStyle = colors[i]; ctx.beginPath();
    s.forEach((v, x) => {
      const px = x * W / Math.max(s.length - 1, 1);
      const py = H - (v / max) * (H - 4) - 2;
      x ? ctx.lineTo(px, py) : ctx.moveTo(px, py);
    });
    ctx.stroke();
  });
}
async function poll() {
  try {
    const s = await (await fetch('/stats')).json();
    document.getElementById('frame').textContent = s.frame;
    document.getElementById('samples').textContent =
      s.samples + (s.preview ? ' (preview)' : '');
    document.getElementById('ms').textContent = s.render_ms.toFixed(1);
    document.getElementById('fps').textContent = s.fps.toFixed(1);
    plot(document.getElementById('stages'),
         [s.history.render, s.history.tonemap, s.history.encode],
         ['#6fb3ff', '#ffd166', '#ef6f6c']);
    plot(document.getElementById('fpsg'), [s.history.fps], ['#9be07f']);
    const eng = document.getElementById('engines');
    if (!eng.childElementCount) {
      for (const name of s.engines) {
        const l = document.createElement('label');
        l.innerHTML = `<input type="radio" name="engine" value="${name}"` +
          (name === s.engine ? ' checked' : '') + `/> ${name}`;
        l.firstChild.onchange = () => fetch('/control',
          {method:'POST', body: JSON.stringify({kind:'engine', name})});
        eng.appendChild(l);
      }
    }
    img.src = '/frame.png?f=' + s.frame;
  } catch (err) {}
  setTimeout(poll, 250);
}
poll();
</script></body></html>
"""

#: ring-buffer length, matching the reference's 100-entry histories
#: (main.cpp:177-184).
HISTORY = 100


def encode_png_bytes(img) -> bytes:
    """Tonemapped u8 (H,W,3|4) -> PNG bytes: native encoder when built
    (native/src/imageio.cpp), pure-Python zlib fallback otherwise."""
    from parallelraytracing_tpu import native
    if native.available():
        return native.encode_png(img, level=1)
    return _png_bytes_py(img)


def _png_bytes_py(img) -> bytes:
    import struct
    import zlib

    h, w, c = img.shape

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


class ViewerState:
    """Shared state between the render loop, the encoder thread, and the
    HTTP handlers."""

    def __init__(self, scene, camera, cfg, engine_name: str,
                 preview_scale: int = 1,
                 display_interval_ms: float = 250.0):
        import jax

        from parallelraytracing_tpu import Film, available_engines, create_renderer

        self.jax = jax
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.film = Film(cfg.width, cfg.height)
        self.engines = available_engines()
        self.engine_name = engine_name
        self.renderer = create_renderer(engine_name)
        self.renderer.init(self.film, scene, camera, cfg)
        # Initialized-engine cache: the reference Inits every backend once
        # and flips between them for free (main.cpp:165-166, 476-485);
        # here engines init lazily on first selection but STAY warm (jit
        # caches included), so switching back is instant.
        self.renderer_cache = {engine_name: self.renderer}
        # Motion-adaptive resolution: while the camera moves (every frame
        # restarts accumulation anyway, main.cpp:506-511) render a
        # 1/preview_scale-resolution frame instead — scale^2 fewer rays,
        # so orbiting stays at interactive rate; at rest the full-res
        # progressive refinement resumes.  The browser upscales the
        # smaller PNG (fixed <img> dims + pixelated rendering).
        self.preview_scale = max(int(preview_scale), 1)
        import jax
        self.preview_engine = ("fused" if jax.devices()[0].platform == "gpu"
                               else "megakernel")
        self.previewing = False
        self.preview_cache: dict = {}
        if self.preview_scale > 1:
            pw = max(8, cfg.width // self.preview_scale)
            ph = max(8, cfg.height // self.preview_scale)
            self.preview_cfg = cfg.replace(width=pw, height=ph)
            self.preview_film = Film(pw, ph)
            # Pre-warm the initial engine's preview program (the
            # Init-everything-up-front spirit of main.cpp:165-166) so the
            # first drag doesn't stall on a jit compile.
            pr = self._preview_renderer(engine_name)
            pr.progressive_render()
            self.preview_film.clear()
            pr.reset_progressive()
        self.lock = threading.Lock()
        self.camera_dirty = False
        self.switch_to = None
        #: live postfx toggle (the a-trous denoiser over the HDR mean;
        #: guides rebuilt per frame from the current camera)
        self.denoise = False
        self._scene_data = None  # baked lazily on first toggle
        self.render_ms = 0.0
        self.fps = 0.0
        self.frame = 0
        self.png_cache = b""
        self.stop = False
        # Display decimation: the per-frame device->host display fetch,
        # tonemap and PNG encode are host work the reference never paid
        # (its device->GL blit, opengl_utils.cpp:51-70), so the render
        # loop FREE-RUNS and the display snapshots on a wall cadence
        # instead (0 restores per-frame display).  Progressive
        # accumulation is unaffected — only how often the browser sees
        # it.
        self.display_interval_ms = float(display_interval_ms)
        self._last_display_t = 0.0
        self._pending = 0                       # pipelined-frame window
        self._window_t0 = time.perf_counter()

        # Per-stage 100-frame ring buffers (main.cpp:177-184 analogue).
        self.history = {k: collections.deque(maxlen=HISTORY)
                        for k in ("render", "tonemap", "encode", "total",
                                  "fps")}
        self.encode_ms = 0.0

        # Encoder thread: single-slot mailbox of the latest display
        # buffer; the render loop never blocks on compression.
        self._encode_ready = threading.Event()
        self._encode_buf = None
        threading.Thread(target=self._encode_loop, daemon=True).start()

    # ------------------------------------------------- input (HTTP thread)
    def control(self, msg: dict) -> None:
        with self.lock:
            kind = msg.get("kind")
            if kind == "rotate":
                # pixels -> degrees, reference feel (main.cpp input scale)
                self.camera.rotate(-0.25 * msg.get("dy", 0),
                                   -0.25 * msg.get("dx", 0))
            elif kind == "translate":
                self.camera.translate(-0.02 * msg.get("dx", 0),
                                      0.02 * msg.get("dy", 0))
            elif kind == "zoom":
                self.camera.zoom(-0.01 * msg.get("dy", 0))
            elif kind == "engine" and msg.get("name") in self.engines:
                self.switch_to = msg["name"]
            elif kind == "denoise":
                self.denoise = bool(msg.get("on"))

    # -------------------------------------------- encoder (its own thread)
    def _encode_loop(self) -> None:
        while not self.stop:
            if not self._encode_ready.wait(timeout=0.25):
                continue
            self._encode_ready.clear()
            buf = self._encode_buf
            if buf is None:
                continue
            t0 = time.perf_counter()
            try:
                self.png_cache = encode_png_bytes(buf)
            except Exception:
                self.png_cache = _png_bytes_py(buf)
            self.encode_ms = (time.perf_counter() - t0) * 1e3

    # -------------------------------------------------------- engine switch
    def _switch_engine(self, name: str) -> None:
        """Engine radio-select: clears the film (main.cpp:476-485); warm
        engines come from the cache (init + jit paid once —
        main.cpp:165-166 Inits every backend up front; here lazily on
        first selection, then kept), cold ones init on first use."""
        from parallelraytracing_tpu import create_renderer
        self.engine_name = name
        cached = self.renderer_cache.get(name)
        if cached is not None:
            self.renderer = cached
            self.renderer.set_camera(self.camera)
            # engines may keep the film in their own storage layout
            # (e.g. sharded's px-sharded Morton order)
            self.film.set_layout(cached.film_layout())
        else:
            self.renderer = create_renderer(name)
            self.renderer.init(self.film, self.scene, self.camera, self.cfg)
            self.renderer_cache[name] = self.renderer
        self.film.clear()
        self.renderer.reset_progressive()

    def _preview_renderer(self, name: str):
        """The low-res twin for motion preview (1/preview_scale
        resolution); cached warm like the full-res engines.  One twin
        serves every engine: the fused engine on a GPU (preview frames
        are latency-bound, and the segmented engines add a per-segment
        dispatch and argsort chain, while semantics are identical), the
        megakernel elsewhere."""
        from parallelraytracing_tpu import create_renderer
        del name  # one shared twin for every engine
        r = self.preview_cache.get("twin")
        if r is None:
            r = create_renderer(self.preview_engine)
            r.init(self.preview_film, self.scene, self.camera,
                   self.preview_cfg)
            self.preview_cache["twin"] = r
        else:
            self.preview_film.set_layout(r.film_layout())
        return r

    def _denoised_display(self):
        """Tonemapped u8 frame through the a-trous denoiser (postfx) —
        same Reinhard+gamma transform as Film.display_numpy."""
        import jax.numpy as jnp
        import numpy as np

        from parallelraytracing_tpu.postfx import denoise_film
        if self._scene_data is None:
            self._scene_data = self.scene.build()
        hdr = denoise_film(self.film, self._scene_data,
                           jnp.asarray(self.camera.ray_params()), self.cfg,
                           iterations=4)
        x = hdr / (1.0 + hdr)
        x = jnp.power(jnp.maximum(x, 0.0), 1.0 / 2.2)
        rgb = (jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
        alpha = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
        return np.asarray(jnp.concatenate([rgb, alpha], axis=-1))

    # ---------------------------------------------------- frame loop (main)
    def run(self) -> None:
        last = time.time()
        while not self.stop:
            now = time.time()
            dt = min(now - last, 0.1)
            last = now
            self._step(dt if dt > 0 else 0.016)

    def _step(self, dt: float) -> None:
        """One frame-loop iteration (split out of run() for tests)."""
        import jax
        with self.lock:
            moved = self.camera.update(dt)
            switch = self.switch_to
            self.switch_to = None

        if switch:
            self._switch_engine(switch)
            self.previewing = False
        if moved:
            # camera move -> SetCamera + film.Clear (main.cpp:506-511)
            if self.preview_scale > 1:
                # motion: drop to the low-res preview twin
                pr = self._preview_renderer(self.engine_name)
                pr.set_camera(self.camera)
                self.preview_film.clear()
                pr.reset_progressive()
                self.previewing = True
            else:
                self.renderer.set_camera(self.camera)
                self.film.clear()
                self.renderer.reset_progressive()
        elif self.previewing:
            # motion stopped: hand back to full-res refinement
            self.renderer.set_camera(self.camera)
            self.film.clear()
            self.renderer.reset_progressive()
            self.previewing = False

        if self.previewing:
            renderer, film = self.preview_cache["twin"], \
                self.preview_film
        else:
            renderer, film = self.renderer, self.film

        # Pipelined dispatch (the frame-scale form of the reference's
        # own no-per-bounce-sync rule, renderer.cu:422-425): frames
        # DISPATCH asynchronously and the loop waits only at display
        # snapshots — or every MAX_PENDING frames, which bounds
        # input-to-photon latency (controls apply to the next dispatched
        # frame).
        MAX_PENDING = 4
        t0 = time.perf_counter()
        renderer.progressive_render()
        # _pending counts DISPATCHED-not-synced frames and persists
        # across film clears: it bounds the device queue depth (and so
        # input latency) — resetting it on motion would let the
        # dispatch rate outrun completion unboundedly during a drag.
        self._pending += 1
        now = time.perf_counter()
        do_display = (self.frame == 0 or self.display_interval_ms <= 0.0
                      or (now - self._last_display_t) * 1e3
                      >= self.display_interval_ms)
        if do_display or self._pending >= MAX_PENDING:
            jax.block_until_ready(film.accum)
            t1 = time.perf_counter()
            # per-frame render cost averaged over the pipelined window
            self.render_ms = (t1 - self._window_t0) * 1e3 / self._pending
            self._pending = 0
            self._window_t0 = t1
        else:
            t1 = time.perf_counter()
        if do_display:
            if self.denoise and not self.previewing:
                display = self._denoised_display()
            else:
                display = film.display_numpy()  # tonemap + fetch
            # hand off to the encoder thread (never blocks the loop)
            self._encode_buf = display
            self._encode_ready.set()
            self._last_display_t = time.perf_counter()
        t2 = time.perf_counter()

        tonemap_ms = (t2 - t1) * 1e3
        total_ms = (t2 - t0) * 1e3
        self.fps = 1.0 / max(t2 - t0, 1e-9)
        self.frame += 1
        self.history["render"].append(round(self.render_ms, 2))
        self.history["tonemap"].append(round(tonemap_ms, 2))
        self.history["encode"].append(round(self.encode_ms, 2))
        self.history["total"].append(round(total_ms, 2))
        self.history["fps"].append(round(self.fps, 2))


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                page = _PAGE.replace("__W__", str(state.cfg.width)) \
                            .replace("__H__", str(state.cfg.height))
                self._send(200, "text/html", page.encode())
            elif self.path.startswith("/frame.png"):
                self._send(200, "image/png", state.png_cache or b"")
            elif self.path.startswith("/stats"):
                body = json.dumps({
                    "frame": state.frame,
                    "samples": (state.preview_film.sample_count
                                if state.previewing
                                else state.film.sample_count),
                    "preview": state.previewing,
                    "render_ms": state.render_ms,
                    "fps": state.fps,
                    "engine": state.engine_name,
                    "engines": state.engines,
                    "history": {k: list(v)
                                for k, v in state.history.items()},
                }).encode()
                self._send(200, "application/json", body)
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path.startswith("/control"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    msg = {}
                state.control(msg)
                self._send(200, "application/json", b"{}")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="interactive viewer")
    p.add_argument("--scene", default="material_test")
    p.add_argument("--ply", default=None, metavar="PATH",
                   help="orbit a PLY mesh instead of a preset (same scene "
                        "recipe as the CLI: mesh on a ground quad under "
                        "an emissive sphere)")
    p.add_argument("--engine", default="auto",
                   help="initial engine (auto = the trace-kernel engines "
                        "on a GPU, the jnp engines elsewhere; "
                        "switchable live in the UI)")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--depth", type=int, default=10)
    p.add_argument("--lens-radius", type=float, default=0.0,
                   help="thin-lens aperture (static per session: lens "
                        "params are jit-static, so a live slider would "
                        "recompile per step)")
    p.add_argument("--focus-distance", type=float, default=10.0)
    p.add_argument("--qmc", action="store_true",
                   help="QMC camera sampling (rotated-Halton jitter/lens "
                        "draws; faster AA/defocus convergence)")
    p.add_argument("--preview-scale", type=int, default=3,
                   help="render at 1/N resolution while the camera moves "
                        "(N^2 fewer rays -> interactive orbiting), full "
                        "resolution at rest; 1 disables")
    p.add_argument("--display-interval-ms", type=float, default=250.0,
                   help="display-snapshot cadence: the render loop "
                        "free-runs and the browser frame refreshes at "
                        "most this often (0 = fetch every frame)")
    p.add_argument("--rr", type=int, default=0, metavar="DEPTH",
                   help="Russian-roulette start depth (0 off)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from parallelraytracing_tpu import RenderConfig, Scene, ScenePreset
    from parallelraytracing_tpu.core.camera import default_camera

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, seed=0,
                       lens_radius=args.lens_radius,
                       focus_distance=args.focus_distance, qmc=args.qmc,
                       russian_roulette_depth=args.rr)
    if args.ply:
        import numpy as _np

        from parallelraytracing_tpu.core.camera import Camera
        from parallelraytracing_tpu.core.scene import ply_showcase_scene
        scene, eye, look = ply_showcase_scene(args.ply)
        eye, look = _np.asarray(eye), _np.asarray(look)
        cam = Camera(eye, look - eye, float(args.width),
                     float(args.height), 100.0)
    else:
        scene = Scene(ScenePreset(args.scene))
        cam = default_camera(args.width, args.height)
    if args.engine == "auto":
        import jax

        from parallelraytracing_tpu.cli import pick_engine
        args.engine = pick_engine(scene, jax.devices()[0].platform)
    state = ViewerState(scene, cam, cfg, args.engine,
                        preview_scale=args.preview_scale,
                        display_interval_ms=args.display_interval_ms)

    server = ThreadingHTTPServer(("127.0.0.1", args.port),
                                 make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer on http://127.0.0.1:{args.port}  "
          f"(scene={args.ply or args.scene}, engine={args.engine})")
    try:
        state.run()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop = True
        server.shutdown()
    return 0


if __name__ == "__main__":
    main()
