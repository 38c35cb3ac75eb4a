"""March kernel vs the XLA march, on the GPU, at 1080p.

Times the staged frame end to end (render_sequence over 8 cameras, ms/frame
median over interleaved runs) for each of --configs:

  kernel      the default config: coarse phase and refine rungs in the
              march kernel (pallas/march_kernel.py)
  xla         coarse_pallas=False, refine_pallas=False: the same scheduler
              with XLA while loops (batched GEMMs + sort compaction)
  kernel_rows the kernel config in image lane order (coarse_block=())

--warps A,B times the kernel config at each march_kernel.NUM_WARPS in the
order A B B A (the persistent compile cache keeps each recompile cheap).
--trace CONFIGS traces one --frames sequence per config and reduces it to
device time per named scope (coarse_kernel / coarse_xla,
rung{i}_div{d}_s{s}, refine_entry_sort, shade_prefix, restore_sort_u32,
other; march-kernel launches by role), the device-busy union and the idle
share: each device event's HLO instruction is mapped to its op_name through
XLA's optimized-HLO dump. Unless --no-phases, the two phases the kernel
replaces are also timed standalone on real inputs — the coarse phase from
the bounding-sphere init state and the first refine rung on its sorted
near-surface bucket — for the XLA march and the kernel at each
(block, num_warps).

Usage: python benchmarks/kernel_vs_xla.py [--res 1920x1080] [--out DIR]
Needs a GPU; writes DIR/kernel_vs_xla.json (traces and dumps are deleted
after reduction).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPES = ("coarse_kernel", "coarse_xla", "refine_entry_sort", "shade_prefix",
          "restore_sort_u32")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def median_ms(fn, arg, reps=5):
    """Median ms of fn(arg) after one warm-up call, and every run."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(arg))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), ts


def hlo_op_names(dump_dir):
    """{(module name, instruction name): op_name} from XLA's optimized-HLO
    text dumps. The caller empties the dump directory before compiling the
    traced config, so module names do not collide across configs.
    Instruction names are also entered with "." replaced by "_", the form
    XLA gives the GPU kernels it emits for them."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]+)"')
    for path in glob.glob(os.path.join(dump_dir, "*after_optimizations.txt")):
        module = None
        with open(path) as fh:
            for line in fh:
                if module is None and line.startswith("HloModule "):
                    module = line.split()[1].rstrip(",")
                m = pat.match(line)
                if m:
                    out[(module, m.group(1))] = m.group(2)
                    out[(module, m.group(1).replace(".", "_"))] = m.group(2)
    return out


def scope_of(op_name):
    for s in SCOPES:
        if s in op_name:
            return s
    m = re.search(r"rung\d+_div\d+_s\d+", op_name)
    return m.group(0) if m else "other"


def kernel_role(name):
    """Scope of a march-kernel launch from its role name
    (march_kernel.march_state names each launch
    march_kernel_{default|fine}_{steps|dry})."""
    m = re.match(r"march_kernel_(default|fine)_(\w+)", name)
    if not m:
        return None
    return "coarse_kernel" if m.group(1) == "default" else f"fine_kernel_{m.group(2)}"


def scope_times(trace_dir, op_names):
    """Device time by named scope in one traced window, the busy union and
    the idle share. Device events are those of the GPU planes' stream lines
    (or of every line carrying an ``hlo_op`` stat when there is no GPU
    plane). Each is attributed through its (hlo_module, hlo_op) stats or,
    inside a command buffer (hlo_op "command_buffer"), its kernel name; a
    march-kernel launch by its role name; a library kernel (cuBLAS, CUB)
    that maps to no instruction inherits the scope of the event before it
    on the stream."""
    import jax

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)[0]
    pd = jax.profiler.ProfileData.from_file(path)
    events, lines = [], {}
    for plane in pd.planes:
        gpu = plane.name.startswith("/device:GPU")
        plane_lines = list(plane.lines)
        streams = [ln for ln in plane_lines if ln.name.startswith("Stream")]
        for line in plane_lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if gpu and streams and not line.name.startswith("Stream"):
                continue
            for e in evs:
                st = {k: str(v) for k, v in e.stats}
                if "hlo_op" in st or (gpu and streams):
                    events.append((e.start_ns, e.duration_ns, e.name, st))
    sums, unmapped, library, scope = {}, 0, {}, "unmapped"
    for _, dur, name, st in sorted(events, key=lambda e: e[0]):
        module, op = st.get("hlo_module", ""), st.get("hlo_op", "")
        op_name = op_names.get((module, op)) or op_names.get((module, name))
        role = kernel_role(name)
        if role is not None:
            scope = role
        elif op_name is not None:
            scope = scope_of(op_name)
        else:
            unmapped += 1
            library[name[:60]] = library.get(name[:60], 0.0) + dur / 1e6
        sums[scope] = sums.get(scope, 0.0) + dur / 1e6
    busy, end = 0.0, -1.0
    for a, d, _, _ in sorted(events):
        b = a + d
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(a + d for a, d, _, _ in events) - min(a for a, _, _, _ in events)
              if events else 0.0)
    sample = [dict(name=n, dur_us=d / 1e3, stats=st) for _, d, n, st in events[:8]]
    return dict(scope_ms=sums, busy_ms=busy / 1e6, window_ms=window / 1e6,
                idle_share=(1.0 - busy / window) if window else None,
                events=len(events), unmapped_events=unmapped, lines=lines,
                library_ms=sorted(library.items(), key=lambda kv: -kv[1])[:15],
                sample_events=sample)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="1920x1080")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--configs", default="kernel,xla,kernel_rows")
    ap.add_argument("--warps", default="", help="e.g. 4,8: A B B A e2e of kernel")
    ap.add_argument("--trace", default="kernel", help="configs to trace ('' = none)")
    ap.add_argument("--no-phases", action="store_true")
    ap.add_argument("--out", default="bench_out")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    dump = os.path.abspath(os.path.join(args.out, "_hlo_dump"))
    if args.trace:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={dump}"
            " --xla_dump_hlo_as_text --xla_dump_hlo_module_re=.*render_scheduled.*"
        ).strip()
    sys.path.insert(0, REPO)
    import jax
    import numpy as np

    import cudaneuralrender as cnr
    from cudaneuralrender.pallas import march_kernel as mk

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    w, h = (int(v) for v in args.res.split("x"))
    res = dict(card=card(), device=jax.devices()[0].device_kind, res=args.res,
               block=mk.BLOCK, num_warps=mk.NUM_WARPS)
    print(res, flush=True)

    params = cnr.load(os.path.join(REPO, "examples", "assets", "csg_demo.npz"))
    base = cnr.RenderConfig(width=w, height=h, scene="neural_raw", max_steps=6000,
                            march_impl="staged")
    all_configs = {
        "kernel": base,
        "xla": base.replace(coarse_pallas=False, refine_pallas=False),
        "kernel_rows": base.replace(coarse_block=()),
    }
    configs = {k: all_configs[k] for k in args.configs.split(",") if k}
    cams = [cnr.Camera(rotation_y=30.0 + 45.0 * i, rotation_x=-20.0)
            for i in range(args.frames)]

    def sequence_ms(cfg):
        t0 = time.perf_counter()
        jax.block_until_ready(cnr.render_sequence(params, cams, cfg))
        return (time.perf_counter() - t0) * 1e3 / args.frames

    def warm(name, cfg):
        # Two passes: the first may overflow the default ladder and teach
        # the adaptive memo a widened/tuned schedule; the second compiles it.
        for i in range(2):
            t0 = time.perf_counter()
            st = []
            jax.block_until_ready(cnr.render_sequence(params, cams, cfg, stats_out=st))
            print(f"{name}: warm-up pass {i} {time.perf_counter() - t0:.1f} s, "
                  f"fast {[s['fast_path'] for s in st]}", flush=True)

    # End to end, interleaved (a b c, c b a, ...).
    e2e = {k: [] for k in configs}
    for k, cfg in configs.items():
        warm(k, cfg)
    order = list(configs)
    for r in range(args.reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            e2e[k].append(sequence_ms(configs[k]))
    if args.warps:
        a, b = (int(v) for v in args.warps.split(","))
        for wv in (a, b, b, a):
            mk.NUM_WARPS = wv
            jax.clear_caches()
            warm(f"kernel_w{wv}", base)
            e2e.setdefault(f"kernel_w{wv}", []).extend(
                sequence_ms(base) for _ in range(args.reps))
        mk.NUM_WARPS = res["num_warps"]
        jax.clear_caches()
    res["e2e_ms_per_frame"] = {k: dict(median=float(np.median(v)), runs=v)
                               for k, v in e2e.items()}
    for k, v in res["e2e_ms_per_frame"].items():
        print(f"e2e {k}: {v['median']:.3f} ms/frame "
              f"({w * h / v['median'] / 1e3:.2f} Mrays/s) runs {v['runs']}", flush=True)

    # One traced 8-frame sequence per config: device time by named scope.
    res["trace"] = {}
    for k in [c for c in args.trace.split(",") if c]:
        cfg = all_configs[k]
        # Recompile this config with the persistent cache off, so XLA dumps
        # its optimized HLO afresh.
        shutil.rmtree(dump, ignore_errors=True)
        jax.config.update("jax_enable_compilation_cache", False)
        jax.clear_caches()
        warm(k, cfg)
        jax.config.update("jax_enable_compilation_cache", True)
        d = os.path.join(args.out, f"_trace_{k}")
        shutil.rmtree(d, ignore_errors=True)
        jax.profiler.start_trace(d)
        jax.block_until_ready(cnr.render_sequence(params, cams, cfg))
        jax.profiler.stop_trace()
        res["trace"][k] = scope_times(d, hlo_op_names(dump))
        shutil.rmtree(d, ignore_errors=True)
        t = res["trace"][k]
        print(f"trace {k}: per frame " + json.dumps(
            {s: round(v / args.frames, 4) for s, v in sorted(t["scope_ms"].items())})
            + f"; busy {t['busy_ms']:.3f} of {t['window_ms']:.3f} ms, idle share "
            f"{t['idle_share']}, {t['events']} events, {t['unmapped_events']} unmapped",
            flush=True)
    shutil.rmtree(dump, ignore_errors=True)

    if not args.no_phases:
        res["phases_ms"] = standalone_phases(params, base, cams[0], w, h)
    res["card_after"] = card()
    with open(os.path.join(args.out, "kernel_vs_xla.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({k: res[k] for k in ("card", "e2e_ms_per_frame")}))


def standalone_phases(params, base, cam, w, h):
    """The coarse phase and the first refine rung alone, on real inputs."""
    import jax
    import jax.numpy as jnp

    from cudaneuralrender.ops import camera as cam_lib
    from cudaneuralrender.ops import compaction, march
    from cudaneuralrender.pallas import march_kernel as mk
    from cudaneuralrender.render import renderer

    c2w, _ = cam_lib.view_matrices(cam)
    origin, dirs = cam_lib.generate_rays(c2w, h, w, base.focal)
    st0 = march.init_state(origin, dirs, base.bound_center, base.bound_radius)
    D, H = jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST
    coarse_f = renderer.scene_fn(params, base, 0.0, precision=D)
    fine_f = renderer.scene_fn(params, base, 0.0)
    phases = {}
    phases["coarse_xla"] = median_ms(jax.jit(lambda s: march.march_stage(
        coarse_f, origin, dirs, s, num_steps=6000, max_steps=6000,
        march_eps=base.coarse_eps, relax_omega=base.relax_omega).t), st0, 3)[0]
    coarse_state, resolve = jax.jit(lambda s: mk.march_state(
        params, origin, dirs, s, base, march_eps=base.coarse_eps, precision=D,
        relax_omega=base.relax_omega, return_resolve=True))(st0)
    # Rung 0's bucket, built as renderer._refine_phase builds it.
    n = w * h
    cap = max(n // base.refine_schedule[0][0], base.compact_min)
    near = coarse_state.converged | coarse_state.active
    pos, t = compaction.sort_pack_leaves(
        near, (jnp.arange(n, dtype=jnp.int32), coarse_state.t), order=resolve)
    count = jnp.sum(near.astype(jnp.int32))
    pr = renderer.PackedRays(pos=pos, t=t, active=jnp.arange(n) < count,
                             converged=jnp.zeros_like(near))
    sub, bdirs = renderer._pr_bucket(pr, cap, coarse_state.steps, c2w, origin, base)
    steps0 = base.refine_schedule[0][1]
    phases["rung0_xla"] = median_ms(jax.jit(lambda s: march.march_stage(
        fine_f, origin, bdirs, s, num_steps=steps0, max_steps=6000,
        march_eps=base.march_eps).t), sub)[0]
    default_warps = mk.NUM_WARPS
    for block in (64, 128, 256):
        for warps in (2, 4, 8):
            mk.NUM_WARPS = warps
            tag = f"b{block}_w{warps}"
            phases[f"coarse_kernel_{tag}"] = median_ms(jax.jit(lambda s: mk.march_state(
                params, origin, dirs, s, base, march_eps=base.coarse_eps, precision=D,
                relax_omega=base.relax_omega, return_resolve=True, block=block)[0].t), st0)[0]
            phases[f"rung0_kernel_{tag}"] = median_ms(jax.jit(lambda s: mk.march_state(
                params, origin, bdirs, s, base, march_eps=base.march_eps, precision=H,
                num_steps=steps0, block=block).t), sub)[0]
    mk.NUM_WARPS = default_warps
    default_alg = mk.HIGHEST_ALGORITHM
    mk.HIGHEST_ALGORITHM = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3
    phases["rung0_kernel_tf32x3"] = median_ms(jax.jit(lambda s: mk.march_state(
        params, origin, bdirs, s, base, march_eps=base.march_eps, precision=H,
        num_steps=steps0).t), sub)[0]
    mk.HIGHEST_ALGORITHM = default_alg
    for k, v in phases.items():
        print(f"phase {k}: {v:.3f} ms", flush=True)
    return phases


if __name__ == "__main__":
    main()
