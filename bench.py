"""Benchmark: headline metric = rays/sec/device, 1080p sphere-trace.

Renders examples/assets/csg_demo.npz (the reference architecture, trained
in-repo) at 1920x1080 with the full reference march budget (max_steps=6000,
eps=1e-6) through the fast staged-compaction path, and prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "device": {...}}

Every sample syncs on the rendered frames; warm-up batches are excluded.
Median over passes of --frames distinct cameras.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import cudaneuralrender as cnr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="1920x1080")
    # 32 frames: the pipelined batch amortizes the final drain (a real
    # turntable renders 360 frames back-to-back).
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--model", default="examples/assets/csg_demo.npz")
    ap.add_argument("--no-suite", action="store_true",
                    help="skip the extended bench surface (matcap/CSG/"
                         "multigeom/grad)")
    args = ap.parse_args()

    w, h = (int(v) for v in args.res.split("x"))
    params = cnr.load(args.model)
    config = cnr.RenderConfig(
        width=w, height=h, scene="neural_raw", max_steps=args.steps,
        march_impl="staged",
    )
    cameras = [
        cnr.Camera(rotation_y=25.0 + 20.0 * i, rotation_x=10.0)
        for i in range(args.frames)
    ]

    def sync(xs) -> float:
        import jax.numpy as jnp

        return float(jnp.stack([x.sum() for x in xs]).sum())

    # compile + warm up (every camera pose shares one compiled program).
    # Two warm-up batches: the first teaches the adaptive rung tuner
    # (renderer.tune_caps) this geometry's per-rung near-set profile, the
    # second compiles the cap-tuned program it dispatches — so the timed
    # passes below measure the steady-state production schedule. The first
    # warm-up spans ALL the cameras' stats (cheap: stats ride the same
    # pipelined batch) so the taught caps cover every timed pose.
    sync(cnr.render_sequence(params, cameras, config))
    sync(cnr.render_sequence(params, cameras[:1], config))
    # pipelined throughput: all frames dispatched, ONE drain at the end —
    # the serving/turntable mode (render_sequence docstring). Median of 5.
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        sync(cnr.render_sequence(params, cameras, config))
        times.append((time.perf_counter() - t0) / len(cameras))

    import jax

    dev = jax.devices()[0]
    frame_s = float(np.median(times))
    record = {
        "metric": "1080p_sphere_trace_rays_per_sec_per_device",
        "value": round(w * h / frame_s, 1),
        "unit": "rays/s",
        "frame_ms": round(frame_s * 1e3, 3),
        "frame_ms_runs": [round(t * 1e3, 3) for t in times],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }

    if not args.no_suite:
        # Extended tracked surface (round-2 VERDICT item 4): matcap shading,
        # the three CSG demo scenes, batched multi-geometry, and the fast
        # differentiable step — all at the headline resolution so
        # regressions are visible round-over-round. Each scenario is
        # individually guarded; a failure records its error string.
        record["suite"] = _suite(params, config, cameras, w, h)

    print(json.dumps(record), flush=True)
    return 0


def _time_frames(render_fn, n_frames: int, reps: int = 3) -> float:
    """Median-of-reps per-frame seconds; render_fn() must block."""
    render_fn()  # compile + warm (also teaches the adaptive rung tuner)
    render_fn()  # compile the cap-tuned program the tuner taught
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render_fn()
        times.append((time.perf_counter() - t0) / n_frames)
    return float(np.median(times))


def _suite(params, config, cameras, w: int, h: int) -> dict:
    """Extended tracked surface. Every scenario times the SAME protocol as
    the headline — the full --frames-camera pipelined batch (ONE drain
    sync), median over reps — so suite-vs-headline ratios are directly
    comparable. The multigeom scenario pipelines the geometry group to ~15
    programs per drain; the grad scenario reports the single-step cost AND
    the marginal pipelined-loop step (grad_loop_step_ms)."""
    import jax.numpy as jnp

    import cudaneuralrender as cnr

    out: dict = {}
    n_rays = w * h
    n_frames = len(cameras)

    def sync(xs) -> float:
        return float(jnp.stack([x.sum() for x in xs]).sum())

    def scenario(name):
        def deco(fn):
            try:
                out[name] = fn()
            except Exception as e:  # keep the rest of the suite alive
                out[name] = f"ERROR {type(e).__name__}: {e}"[:120]
        return deco

    @scenario("matcap_rays_per_s")
    def _():
        from cudaneuralrender.utils import image_io

        matcap = jnp.asarray(image_io.synthetic_matcap())
        cfg = config.replace(shading="matcap")
        dt = _time_frames(
            lambda: sync(cnr.render_sequence(params, cameras, cfg, matcap)),
            n_frames,
        )
        return round(n_rays / dt, 1)

    for scene in ("many_sphere", "many_cylinder_cut", "displacement"):
        @scenario(f"{scene}_rays_per_s")
        def _(scene=scene):
            cfg = config.replace(scene=scene)
            # animation frames wrap at 360 (the turntable's full cycle —
            # extrapolating the frame counter past it moves the animated
            # CSG scenes outside their designed range)
            frames = [float((i * 40) % 360) for i in range(n_frames)]
            dt = _time_frames(
                lambda: sync(cnr.render_sequence(
                    params, cameras, cfg, frames=frames)),
                n_frames,
            )
            return round(n_rays / dt, 1)

    @scenario("multigeom5_rays_per_s")
    def _():
        import glob

        from cudaneuralrender.models import mlp as mlp_lib
        from cudaneuralrender.render import multigeom

        paths = sorted(glob.glob("examples/assets/*.npz"))
        group = []
        for p in paths:
            try:
                q = cnr.load(p)
            except Exception:
                continue
            if mlp_lib.layer_sizes(q) == mlp_lib.layer_sizes(params):
                group.append(q)
        group = group[:5]
        reps = max(1, 15 // max(len(group), 1))
        batch = list(group) * reps  # ~15 pipelined programs per drain
        dt = _time_frames(
            lambda: sync(multigeom.render_batch_staged(
                batch, cameras[0], config)),
            len(batch),
        )
        out["multigeom_count"] = len(group)
        return round(n_rays / dt, 1)

    @scenario("latency_ms_1080")
    def _():
        return _latency(params, config, reps=12)

    @scenario("latency_ms_512")
    def _():
        return _latency(params, config.replace(width=512, height=512), reps=12)

    @scenario("latency_device_ms_1080")
    def _():
        return _latency_device(params, config, reps=12)

    @scenario("latency_device_ms_512")
    def _():
        return _latency_device(
            params, config.replace(width=512, height=512), reps=12)

    @scenario("grad_loop_step_ms")
    def _():
        from cudaneuralrender.diff import train

        # The production training-step API: staged solve + compacted grad
        # shading + adam update, pipelined via the deferred stats check
        # (one host sync per step). The reused stats dict carries the hit
        # count that sizes the grad bucket across steps. Target = a render
        # from a nearby pose (realistic small-gradient training; a zeros
        # target morphs the geometry so fast the pow2 grad bucket changes
        # and recompiles mid-run).
        target = jnp.asarray(np.asarray(cnr.render_staged(
            params, cnr.Camera(rotation_y=26.0, rotation_x=10.0), config)))
        # lr=1e-4: stable near-converged training. Throughput is
        # lr-independent, but an aggressive lr drifts the geometry until
        # the hit count crosses the pow2 grad-bucket boundary mid-loop,
        # which costs a redo + recompile (correct, measured, and exactly
        # what this benchmark must not randomly include).
        state = train.init_train_state(params, 1e-4)
        st: dict = {}

        def step():
            s, loss = train.pixel_train_step_fast(
                state, cameras[0], target, config, 1e-4, stats_out=st)
            float(loss)

        step()  # populate stats + compile the pipelined variant
        dt = _time_frames(step, 1, reps=3)
        out["grad_step_ms_single"] = round(dt * 1e3, 1)
        out["grad_step_mrays_per_s"] = round(n_rays / dt / 1e6, 2)

        # Pipelined multi-step training (train.train_loop_fast): checks
        # deferred one step so the host sync overlaps the next step's
        # device work — the production training-loop mode. The reported
        # number is the marginal pipelined step: (17-step loop - 1-step
        # loop) / 16, which cancels the synchronous seed step both share.
        train.train_loop_fast(state, [cameras[0]] * 3, target, config, 1e-4)
        t0 = time.perf_counter()
        train.train_loop_fast(state, [cameras[0]] * 1, target, config, 1e-4)
        t_seed = time.perf_counter() - t0
        t0 = time.perf_counter()
        train.train_loop_fast(state, [cameras[0]] * 17, target, config, 1e-4)
        return round((time.perf_counter() - t0 - t_seed) / 16 * 1e3, 1)

    return out


def _latency_device(params, config, reps: int = 12) -> float:
    """Single-frame latency WITHOUT the pixel transfer: dispatch one
    interactive frame and block on its completion (no fetch) — device
    frame time plus the lone-dispatch overhead."""
    import jax

    import cudaneuralrender as cnr

    r = cnr.Renderer(params, config)
    poses = [
        cnr.Camera(rotation_y=25.0 + 30.0 * i, rotation_x=10.0)
        for i in range(reps)
    ]
    for cam in poses[:3]:
        jax.block_until_ready(r.render_interactive_packed(cam))
    times = []
    for cam in poses:
        t0 = time.perf_counter()
        jax.block_until_ready(r.render_interactive_packed(cam))
        times.append(time.perf_counter() - t0)
    return round(float(np.median(times)) * 1e3, 2)


def _latency(params, config, reps: int = 12) -> float:
    """Single-frame LATENCY (ms): what a live viewer actually waits.

    The pipelined-throughput headline never applies to an interactive
    loop — a viewer requests one frame and blocks on its pixels. This
    times the optimistic interactive path (Renderer.render_interactive:
    ONE host sync per frame, the fast-path stats check deferred into the
    next frame — render/viewer.py's production mode) across distinct
    camera poses and reports the median. The reference's analogue is its
    FPS title bar — a latency metric, not a throughput one
    (src/main.cpp:111-128).
    """
    import cudaneuralrender as cnr

    r = cnr.Renderer(params, config)
    poses = [
        cnr.Camera(rotation_y=25.0 + 30.0 * i, rotation_x=10.0)
        for i in range(reps)
    ]
    for cam in poses[:3]:  # compile + warm; the deferred check of call 1
        # teaches the adaptive caps during call 2, call 3 compiles the
        # tuned program — the timed loop below sees steady state only
        r.render_frame_interactive(cam)
    times = []
    for cam in poses:
        t0 = time.perf_counter()
        # The one sync: the u32-packed pixel fetch + host unpack — the
        # full wall a viewer waits for a displayable frame.
        r.render_frame_interactive(cam)
        times.append(time.perf_counter() - t0)
    return round(float(np.median(times)) * 1e3, 2)


if __name__ == "__main__":
    sys.exit(main())
