#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU (or four, --four-cards).

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # phase 1 + the sharded paths on 4 cards

Phases, each checked against the repository's plain references:

  1. environment: JAX version and devices, the card's name and power limit,
     XLA_FLAGS, the compile-cache directory; the platform must be ``gpu``.
  2. march kernel (pallas/march_kernel.py, Triton route) against
     march.march_stage at 1080p under "highest" matmul precision, at the
     coarse epsilon and at march_eps; the chain's SDF error at each
     precision against a float64 NumPy chain on 1M points.
  3. main path: the 1080p render_staged frame (neural_raw, max_steps=6000)
     compiled (memory analysis, compile seconds), rendered, and compared
     with the dense render_image; render_sequence over 8 cameras, timed.
  4. breadth at 512²: matcap shading (generated matcap), many_sphere,
     many_cylinder_cut, and the 4-input anim_demo at frame 30.
  5. viewer path: Renderer.render_frame_interactive over 5 poses at 512².
  6. trainer: train_loop_fast for 3 steps at 512², and one fast step
     against the dense implicit-gradient step pixel_train_step.

--four-cards runs phase 1 and only the sharded comparisons on a 4-card
("data",) mesh: render_image_sharded_staged at 1080p against one-card
render_staged, and pixel_train_step_sharded against pixel_train_step.

Any failed check raises: the script then exits non-zero without its last
line. The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Geometries are the in-repo examples/assets/*.npz (trained weights).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "examples", "assets")

# Tolerances of the repository's tests (tests/test_render.py,
# tests/test_parallel.py), reused here at real sizes.
HIT_AGREE = 0.99       # staged vs dense hit agreement
COLOR_ATOL = 1e-3      # per channel, on common hits
COLOR_FRAC = 0.97      # share of common hits within COLOR_ATOL


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found: no NVIDIA driver on this machine")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def timed(fn, reps):
    """(last result, median seconds) over ``reps`` runs after one warm-up."""
    import jax
    import numpy as np

    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def compare_images(name, img, ref):
    """Staged image vs dense reference at the test suite's tolerances."""
    import numpy as np

    img, ref = np.asarray(img), np.asarray(ref)
    assert img.shape == ref.shape, (name, img.shape, ref.shape)
    assert np.isfinite(img).all(), f"{name}: non-finite pixels"
    hit_i, hit_r = img[..., 3] > 0, ref[..., 3] > 0
    agree = float((hit_i == hit_r).mean())
    both = hit_i & hit_r
    close = float(np.all(np.abs(img[both] - ref[both]) < COLOR_ATOL, axis=-1).mean())
    log(f"  {name}: hits {int(hit_i.sum())} vs dense {int(hit_r.sum())}, "
        f"hit agreement {agree:.6f} (>= {HIT_AGREE}), common hits within "
        f"{COLOR_ATOL}: {close:.6f} (>= {COLOR_FRAC})")
    assert hit_r.sum() > 0, f"{name}: the reference render is empty"
    assert agree >= HIT_AGREE, f"{name}: hit agreement {agree}"
    assert close >= COLOR_FRAC, f"{name}: common-hit color match {close}"


def load_geometry(name):
    import cudaneuralrender as cnr

    return cnr.load(os.path.join(ASSETS, name))


# anim_demo was trained on frame / 180 - 1 (examples/train_animated.py).
ANIM_FRAME_30 = 30.0 / 180.0 - 1.0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_environment(min_devices: int):
    import jax

    log("== phase 1: environment")
    log(f"  jax {jax.__version__}, devices {jax.devices()}")
    log(f"  nvidia-smi: {nvidia_smi_line()}")
    log(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"  compile cache: {jax.config.jax_compilation_cache_dir}")
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX's platform is {platform!r}")
    if len(jax.devices()) < min_devices:
        raise SystemExit(f"needs {min_devices} GPUs, found {len(jax.devices())}")


def phase_kernel_parity(width=1920, height=1080, n_points=1 << 20):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cudaneuralrender as cnr
    from cudaneuralrender.ops import camera as cam_lib, march
    from cudaneuralrender.pallas import march_kernel as mk
    from cudaneuralrender.render.renderer import scene_fn

    log(f"== phase 2: march kernel vs march_stage at {width}x{height}")
    params = load_geometry("csg_demo.npz")
    cfg = cnr.RenderConfig(width=width, height=height, scene="neural_raw")
    c2w, _ = cam_lib.view_matrices(cnr.Camera(rotation_y=30.0, rotation_x=-20.0))
    origin, dirs = cam_lib.generate_rays(c2w, height, width, cfg.focal)
    st = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    hp = jax.lax.Precision.HIGHEST
    atol = 1e-4
    with jax.default_matmul_precision("highest"):
        f = scene_fn(params, cfg, 0.0)
        for eps in (cfg.coarse_eps, cfg.march_eps):
            kern = jax.jit(lambda s, e=eps: mk.march_state(
                params, origin, dirs, s, cfg, march_eps=e, precision=hp))
            xla = jax.jit(lambda s, e=eps: march.march_stage(
                f, origin, dirs, s, num_steps=cfg.max_steps,
                max_steps=cfg.max_steps, march_eps=e))
            sk, tk = timed(lambda: kern(st), 3)
            sx, tx = timed(lambda: xla(st), 1)
            a, b = np.asarray(sk.converged), np.asarray(sx.converged)
            agree = float((a == b).mean())
            both = a & b
            dt = np.abs(np.asarray(sk.t)[both] - np.asarray(sx.t)[both])
            within = float((dt <= atol).mean())
            log(f"  eps={eps:g}: converged kernel {a.sum()} / march_stage {b.sum()}, "
                f"set agreement {agree:.6f}; common lanes {both.sum()}, |dt| <= {atol:g} "
                f"on {within:.6f} (max {dt.max():.3e}); steps {int(sk.steps)} / "
                f"{int(sx.steps)}; kernel {tk * 1e3:.3f} ms, march_stage {tx * 1e3:.3f} ms")
            assert agree >= 0.9999, f"converged-set agreement {agree}"
            assert within >= 0.999, f"only {within} of common lanes within {atol}"

    # The widest net the kernel takes (march_kernel.MAX_WIDTH), random
    # weights from a seed: it must compile on the card and march like XLA.
    wide = cnr.init_mlp(jax.random.key(0), sizes=(3,) + (mk.MAX_WIDTH,) * 3 + (1,))
    wcfg = cfg.replace(width=256, height=256)
    wo, wd = cam_lib.generate_rays(c2w, 256, 256, wcfg.focal)
    wst = march.init_state(wo, wd, wcfg.bound_center, wcfg.bound_radius)
    with jax.default_matmul_precision("highest"):
        sk = mk.march_state(wide, wo, wd, wst, wcfg, march_eps=1e-3, precision=hp,
                            num_steps=64)
        sx = march.march_stage(cnr.neural_sdf_fn(wide, 0.0), wo, wd, wst, num_steps=64,
                               max_steps=wcfg.max_steps, march_eps=1e-3)
    a, b = np.asarray(sk.converged), np.asarray(sx.converged)
    agree = float((a == b).mean())
    log(f"  {mk.MAX_WIDTH}-wide net at 256²: converged {a.sum()} / {b.sum()}, "
        f"agreement {agree:.6f}")
    assert agree >= 0.999, agree

    log(f"  chain SDF error vs float64 on {n_points} points in [-1.2, 1.2]^3:")
    pts = np.asarray(jax.random.uniform(jax.random.key(0), (n_points, 3),
                                        minval=-1.2, maxval=1.2))
    h = pts.astype(np.float64)
    for i, layer in enumerate(params):
        h = h @ np.asarray(layer.w, np.float64) + np.asarray(layer.b, np.float64)
        if i + 1 < len(params):
            h = np.maximum(h, 0.0)
    ref = h[:, 0]
    errs = {}
    pj = jnp.asarray(pts)
    for name, prec in (
        ("kernel DEFAULT (TF32)", jax.lax.Precision.DEFAULT),
        ("kernel HIGHEST (IEEE f32)", jax.lax.Precision.HIGHEST),
        ("kernel TF32x3", jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3),
    ):
        v = np.asarray(jax.jit(lambda p, q=prec: mk.sdf_chain(params, p, precision=q))(pj))
        errs[name] = float(np.abs(v - ref).max())
    for name, prec in (("XLA DEFAULT", jax.lax.Precision.DEFAULT),
                       ("XLA HIGH", jax.lax.Precision.HIGH),
                       ("XLA HIGHEST", jax.lax.Precision.HIGHEST)):
        v = np.asarray(jax.jit(lambda p, q=prec: cnr.mlp.apply_scalar(params, p, precision=q))(pj))
        errs[name] = float(np.abs(v - ref).max())
    for name, e in errs.items():
        log(f"    {name:28s} max|err| = {e:.3e}")
    assert errs["kernel HIGHEST (IEEE f32)"] < cfg.march_eps
    assert errs["kernel DEFAULT (TF32)"] < cfg.coarse_eps / 10


def phase_main_path(width=1920, height=1080, n_cameras=8):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cudaneuralrender as cnr
    from cudaneuralrender.ops import shading
    from cudaneuralrender.render import renderer

    log(f"== phase 3: render_staged at {width}x{height}, max_steps=6000")
    params = load_geometry("csg_demo.npz")
    cfg = cnr.RenderConfig(width=width, height=height, scene="neural_raw",
                           max_steps=6000, march_impl="staged")
    cam = cnr.Camera(rotation_y=30.0, rotation_x=-20.0)
    frame = jnp.zeros((), jnp.float32)
    t0 = time.perf_counter()
    # The frame program, lowered with the camera angles as traced scalars.
    program = jax.jit(lambda p, rx, ry, fr: renderer._render_scheduled(
        p, cnr.Camera(rx, ry), cfg, None, fr))
    compiled = program.lower(params, jnp.float32(cam.rotation_x),
                             jnp.float32(cam.rotation_y), frame).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    # The first frame of a (geometry, config) may outgrow the default refine
    # ladder: it re-renders with widened buckets and teaches the adaptive
    # memo, so the next frame of the same pose takes the fast path.
    for attempt in ("first", "second"):
        stats = {}
        img = jax.block_until_ready(cnr.render_staged(params, cam, cfg, stats_out=stats))
        log(f"  stats_out ({attempt} frame): {stats}")
    assert stats["fast_path"], stats
    with jax.default_matmul_precision("highest"):
        ref = cnr.render_image(params, cam, cfg)
    # the u8 round trip the default (rgba_packed) staged path applies
    ref = shading.unpack_rgba_u32(shading.pack_rgba_u32(ref))
    compare_images(f"{width}x{height} staged vs dense", img, ref)

    cams = [cnr.Camera(rotation_y=30.0 + 45.0 * i, rotation_x=-20.0)
            for i in range(n_cameras)]
    frames = cnr.render_sequence(params, cams, cfg)  # compiles + teaches caps
    jax.block_until_ready(frames)
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(cnr.render_sequence(params, cams, cfg))
        ms.append((time.perf_counter() - t0) * 1e3 / n_cameras)
    med = float(np.median(ms))
    log(f"  render_sequence over {n_cameras} cameras: median {med:.3f} ms/frame "
        f"({width * height / med * 1e3 / 1e6:.2f} Mrays/s) per run {ms} "
        f"[{nvidia_smi_line()}]")


def phase_breadth(size=512):
    import jax
    import jax.numpy as jnp

    import cudaneuralrender as cnr
    from cudaneuralrender.utils import image_io

    log(f"== phase 4: breadth at {size}x{size}")
    csg = load_geometry("csg_demo.npz")
    base = cnr.RenderConfig(width=size, height=size, max_steps=6000,
                            march_impl="staged", rgba_packed=False)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=-20.0)
    matcap = jnp.asarray(image_io.synthetic_matcap())
    cases = [
        ("matcap", csg, base.replace(scene="neural_raw", shading="matcap"), matcap, 0.0),
        ("many_sphere", csg, base.replace(scene="many_sphere"), None, 0.0),
        ("many_cylinder_cut", csg, base.replace(scene="many_cylinder_cut"), None, 0.0),
        ("anim_demo frame 30", load_geometry("anim_demo.npz"),
         base.replace(scene="neural_raw", num_inputs=4), None, ANIM_FRAME_30),
    ]
    for name, params, cfg, mc, fr in cases:
        stats = {}
        img = cnr.render_staged(params, cam, cfg, mc, fr, stats_out=stats)
        with jax.default_matmul_precision("highest"):
            ref = cnr.render_image(params, cam, cfg, mc, fr)
        compare_images(f"{name} (fast_path={stats['fast_path']})", img, ref)


def phase_viewer(size=512, n_poses=5):
    import numpy as np

    import cudaneuralrender as cnr

    log(f"== phase 5: Renderer.render_frame_interactive at {size}x{size}")
    params = load_geometry("csg_demo.npz")
    cfg = cnr.RenderConfig(width=size, height=size, max_steps=6000, march_impl="staged")
    r = cnr.Renderer(params, cfg)
    r.render_frame_interactive(cnr.Camera(rotation_y=10.0))  # compile
    lat = []
    for i in range(n_poses):
        t0 = time.perf_counter()
        img = r.render_frame_interactive(cnr.Camera(rotation_y=20.0 + 15.0 * i,
                                                    rotation_x=-10.0))
        lat.append((time.perf_counter() - t0) * 1e3)
        assert img.shape == (size, size, 4) and img.dtype == np.uint8
        assert (img[..., 3] > 0).mean() > 0.01, "empty interactive frame"
    log(f"  latency median {np.median(lat):.3f} ms over {n_poses} poses {lat} "
        f"last_stats {r.last_stats}")


def phase_trainer(size=512, n_steps=3):
    import jax
    import numpy as np

    import cudaneuralrender as cnr
    from cudaneuralrender.diff import train as train_lib

    log(f"== phase 6: train_loop_fast, {n_steps} steps at {size}x{size}")
    params = load_geometry("csg_demo.npz")
    cfg = cnr.RenderConfig(width=size, height=size, max_steps=6000, march_impl="staged")
    cam = cnr.Camera(rotation_y=30.0, rotation_x=-20.0)
    with jax.default_matmul_precision("highest"):
        target = cnr.render_image(params, cnr.Camera(rotation_y=34.0, rotation_x=-20.0), cfg)
    t0 = time.perf_counter()
    _, losses = train_lib.train_loop_fast(
        train_lib.init_train_state(params, lr=1e-3), [cam] * n_steps, target, cfg)
    log(f"  losses {losses} ({time.perf_counter() - t0:.1f} s incl. compile)")
    assert len(losses) == n_steps and np.all(np.isfinite(losses)), losses

    # One fast step (staged solve + packed grad) against the dense
    # implicit-gradient step. march_precision="full" makes both solves march
    # the same reference-ordered HIGHEST steps, and grad_shade_precision=
    # "highest" keeps TF32 out of the shading chain, so the two differ only
    # in summation order.
    pcfg = cfg.replace(march_precision="full", grad_shade_precision="highest")
    s0 = train_lib.init_train_state(params, lr=1e-3)
    fast_state, fast_loss = train_lib.pixel_train_step_fast(s0, cam, target, pcfg)
    ref_state, ref_loss = train_lib.pixel_train_step(s0, cam, target, pcfg)
    log(f"  one step: fast loss {float(fast_loss):.9e}, dense loss {float(ref_loss):.9e}")
    np.testing.assert_allclose(float(fast_loss), float(ref_loss), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(fast_state.params),
                    jax.tree_util.tree_leaves(ref_state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)
    log("  fast step == dense step (loss rtol 1e-5, params rtol 1e-4 atol 1e-6)")


def phase_four_cards(width=1920, height=1080, train_size=512):
    import jax
    import numpy as np

    import cudaneuralrender as cnr
    from cudaneuralrender.diff import train as train_lib
    from cudaneuralrender.parallel import mesh as mesh_lib
    from cudaneuralrender.parallel.sharding import (
        pixel_train_step_sharded, render_image_sharded_staged)

    log("== phase 7: four cards, ('data',) mesh")
    params = load_geometry("csg_demo.npz")
    m = mesh_lib.make_mesh((4,), ("data",), jax.devices()[:4])
    # A first refine bucket of half the image holds csg_demo's near set, so
    # neither side re-renders with a widened schedule: one compile per side.
    cfg = cnr.RenderConfig(width=width, height=height, scene="neural_raw",
                           max_steps=6000, march_impl="staged",
                           refine_schedule=((2, 16), (8, 24), (32, 64), (256, 0)))
    cam = cnr.Camera(rotation_y=30.0, rotation_x=-20.0)
    stats = {}
    sharded = np.asarray(render_image_sharded_staged(params, cam, cfg, m, stats_out=stats))
    single = np.asarray(cnr.render_staged(params, cam, cfg))
    hit_a, hit_b = sharded[..., 3] > 0, single[..., 3] > 0
    diff = np.abs(sharded - single).max()
    log(f"  sharded staged {width}x{height}: fast_path {stats['fast_path']}, hits "
        f"{int(hit_a.sum())} vs one card {int(hit_b.sum())}, differing hit pixels "
        f"{int((hit_a != hit_b).sum())}, max |diff| {diff:.3e}")
    t0 = time.perf_counter()
    jax.block_until_ready(render_image_sharded_staged(params, cam, cfg, m))
    log(f"  sharded frame {(time.perf_counter() - t0) * 1e3:.3f} ms (warm, one frame)")
    # tests/test_parallel.py:176 asks for identical hit sets and atol 1e-2
    # at 32². At 1080p a few grazing pixels may converge on another sheet:
    # over-relaxation restarts at every rung, and which rung a ray rides
    # depends on its shard's bucket layout (the XLA rungs show the same).
    # So: hit sets equal but for 1e-4 of the pixels, and 99.9% of common
    # hits within 1e-2.
    agree = float((hit_a == hit_b).mean())
    both = hit_a & hit_b
    close = float((np.abs(sharded[both] - single[both]).max(-1) <= 1e-2).mean())
    log(f"  hit agreement {agree:.6f} (>= 0.9999), common hits within 1e-2: "
        f"{close:.6f} (>= 0.999)")
    assert agree >= 0.9999 and close >= 0.999

    tcfg = cfg.replace(width=train_size, height=train_size, march_impl="while")
    with jax.default_matmul_precision("highest"):
        target = cnr.render_image(params, cnr.Camera(rotation_y=34.0, rotation_x=-20.0), tcfg)
    s0 = train_lib.init_train_state(params, lr=1e-3)
    sh_state, sh_loss = pixel_train_step_sharded(s0, cam, target, tcfg, m)
    ref_state, ref_loss = train_lib.pixel_train_step(s0, cam, target, tcfg)
    log(f"  sharded train step at {train_size}²: loss {float(sh_loss):.9e} vs "
        f"one card {float(ref_loss):.9e}")
    np.testing.assert_allclose(float(sh_loss), float(ref_loss), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(sh_state.params),
                    jax.tree_util.tree_leaves(ref_state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)
    log("  sharded step == one-card step (loss rtol 1e-5, params rtol 1e-4 atol 1e-6)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded comparisons on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import jax

    import cudaneuralrender  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    phase_environment(4 if args.four_cards else 1)
    if args.four_cards:
        phase_four_cards()
    else:
        phase_kernel_parity()
        phase_main_path()
        phase_breadth()
        phase_viewer()
        phase_trainer()
    dev = jax.devices()[0]
    count = len(jax.devices())
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
