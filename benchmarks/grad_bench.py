"""Differentiable-mode benchmark + gradient parity (BASELINE config 4).

Measures the pixel-loss -> weight-gradient step (implicit-function VJP,
diff/implicit.py) and validates the gradient against central finite
differences on a random weight direction.

Two step implementations:
  * dense (default) — the march runs gradient-severed INSIDE the grad
    program (round-1 behavior; the trainable analogue of the reference's
    dense loop, src/volumeRender_kernel.cu:652-689).
  * --fast — t* precomputed through the staged scheduler + march kernel
    (diff/solve.py::solve_surface), then the jitted grad step touches each
    ray exactly twice. The 1080p number recorded in docs/ARCHITECTURE.md.

The PHASE BREAKDOWN of the fast step (solve / packed sort / implicit-t
grad / shading-normal variants / cap sensitivity / grad-parity of the
HIGH shade chain) lives in benchmarks/exp_grad.py — the measurements
behind config.grad_shade_precision and the pipelined train_loop_fast
(round-4 VERDICT item 6); bench.py's grad_loop_step_ms tracks the
production pipelined-loop step.

Usage: python benchmarks/grad_bench.py [--res 128] [--fast] [--iters 5]
"""
from __future__ import annotations

import argparse
import sys
import time

import os as _os

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    # Pin the CPU platform via jax.config before first use (an env var may
    # come too late if jax was imported already).
    sys.argv.remove("--cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.diff import losses


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="examples/assets/csg_demo.npz")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--width", type=int, default=0,
                    help="override width (e.g. --width 1920 --res 1080 for 1080p)")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--fast", action="store_true",
                    help="precompute t* through the staged scheduler "
                         "(solve_surface) instead of the in-trace dense march")
    ap.add_argument("--fd-eps", type=float, default=3e-4)
    ap.add_argument("--no-fd", action="store_true", help="skip FD parity")
    args = ap.parse_args()

    h, w = args.res, (args.width or args.res)
    params = cnr.load(args.model)
    cfg = cnr.RenderConfig(width=w, height=h, scene="neural_raw",
                           max_steps=args.steps)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=15.0)
    target = cnr.render_image(params, cnr.Camera(rotation_y=35.0, rotation_x=15.0), cfg)
    n_rays = h * w

    if args.fast:
        from cudaneuralrender.diff.solve import solve_surface, solve_surface_async
        from cudaneuralrender.ops import compaction

        _st = {}
        _t0, _h0 = solve_surface(params, cam, cfg, stats_out=_st)
        _cap = compaction.capacity_pow2_of(
            _st.get("hits") or int(jnp.sum(_h0)), n_rays,
            minimum=cfg.compact_min)
        _cap = _cap if _cap < n_rays else None

        def grad_value(p):
            # Pipelined: grad program dispatches behind the solve; the
            # deferred stats check replaces the mid-step host sync. On a
            # rare fast-path failure (e.g. a refine-bucket overflow during
            # an FD perturbation sweep) redo via the synchronous solve —
            # the same fallback the production step uses — instead of
            # aborting the benchmark.
            t_star, hit, check = solve_surface_async(p, cam, cfg)
            out = _fast_grad(p, t_star, hit)
            if not check():
                t_star, hit = solve_surface(p, cam, cfg)
                out = _fast_grad(p, t_star, hit)
            return out

        @jax.jit
        def _fast_grad(p, t_star, hit):
            return jax.value_and_grad(
                lambda q: losses.pixel_loss(
                    q, cam, cfg, target, t_star=t_star, hit=hit,
                    compact_cap=_cap,
                )
            )(p)

        loss_fn = lambda p: losses.pixel_loss(  # FD oracle: same objective
            p, cam, cfg, target, t_star=_t0, hit=_h0, compact_cap=_cap
        )
        label = "fast (staged solve + compacted implicit grad)"
    else:
        loss_fn = lambda p: losses.pixel_loss(p, cam, cfg, target)
        grad_value = jax.jit(jax.value_and_grad(loss_fn))
        label = "dense (in-trace march)"

    loss, grads = grad_value(params)
    jax.block_until_ready(grads)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        loss, grads = grad_value(params)
        float(loss)
        jax.block_until_ready(grads)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"value+grad step [{label}]: {dt*1e3:.1f} ms at {h}x{w} "
          f"({n_rays/dt/1e6:.2f} Mrays/s through fwd+bwd), loss={float(loss):.6f}")
    if args.no_fd:
        return 0

    # FD parity on a random unit direction in weight space. The raw pixel
    # loss is DISCONTINUOUS at the silhouette (one hit-mask flip under the
    # eps-shift swamps the smooth signal — a single flipped pixel moves the
    # FD quotient by ~1/(4*N*eps)), so parity is checked on the smooth part:
    # mean squared depth over interior pixels whose 4-neighborhood stays hit
    # (tests/test_diff.py::test_grad_parity_implicit_vs_finite_difference
    # uses the same estimator).
    from cudaneuralrender.diff import implicit

    _, hit0 = implicit.render_depth_diff(params, cam, cfg)
    hit2d = np.asarray(hit0).reshape(h, w)
    stable = hit2d.copy()
    stable[1:] &= hit2d[:-1]
    stable[:-1] &= hit2d[1:]
    stable[:, 1:] &= hit2d[:, :-1]
    stable[:, :-1] &= hit2d[:, 1:]
    stable_flat = jnp.asarray(stable.reshape(-1))
    n_stable = int(stable.sum())
    if n_stable < 16:
        print("FD parity skipped: too few stable interior pixels")
        return 0

    @jax.jit
    def depth_loss(p):
        t, _ = implicit.render_depth_diff(p, cam, cfg)
        return jnp.sum(jnp.where(stable_flat, t**2, 0.0)) / n_stable

    key = jax.random.key(0)
    direction = jax.tree_util.tree_map(
        lambda x: jax.random.normal(jax.random.fold_in(key, x.size), x.shape, x.dtype),
        params,
    )
    norm = jnp.sqrt(sum(jnp.sum(d ** 2) for l in direction for d in (l.w, l.b)))
    direction = jax.tree_util.tree_map(lambda d: d / norm, direction)

    dgrads = jax.jit(jax.grad(depth_loss))(params)
    analytic = sum(
        jnp.sum(g * d)
        for gl, dl in zip(dgrads, direction)
        for g, d in ((gl.w, dl.w), (gl.b, dl.b))
    )
    eps = args.fd_eps

    def shift(sign):
        return jax.tree_util.tree_map(lambda x, d: x + sign * eps * d, params, direction)

    fd = (float(depth_loss(shift(+1.0))) - float(depth_loss(shift(-1.0)))) / (2 * eps)
    rel = abs(float(analytic) - fd) / max(abs(fd), 1e-12)
    print(f"directional derivative (stable-interior depth loss, {n_stable} px): "
          f"analytic={float(analytic):.6e} fd={fd:.6e} "
          f"rel_err={rel:.3e} ({'PASS' if rel < 0.05 else 'FAIL'})")
    return 0 if rel < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
