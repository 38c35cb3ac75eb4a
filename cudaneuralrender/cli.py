"""Command-line interface.

Mirrors the reference binary's flag surface (src/main.cpp:536-631):
  -i input geometry (.h5/.npz)  REQUIRED
  -o output path/prefix          (default: {input})
  -H/-W height/width             (default 512)
  -M matcap path                 (enables matcap shading, main.cpp:655-662)
  -rx/-ry rotation degrees, -z zoom (default 2 -> eye at distance 2)
  --single   render one frame and exit (prints the MTexels/s line,
             main.cpp:434-438 format)
  --spin     360-frame turntable with zero-padded numbering (main.cpp:445-478)
  --animation  4-input (x,y,z,frame) mode (main.cpp:619-621)

plus framework extensions: --scene, --steps, --march,
--normal-mode, --serve (interactive browser viewer — the GLUT-window
equivalent), --save-ckpt.

Reference quirks deliberately fixed: -rz actually parses its own value (the
reference reads -ry's, main.cpp:602-606) but is still unused by the orbit
camera (documented, parity); frame numbering pads to any count, not 999.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cnr-render",
        description="Neural-SDF sphere-trace renderer "
        "(capability parity with neuralSDFRenderer)",
    )
    p.add_argument("-i", dest="input", required=True, help="neural geometry (.h5/.npz)")
    p.add_argument("-o", dest="output", default=None, help="output path prefix")
    p.add_argument("-H", dest="height", type=int, default=512)
    p.add_argument("-W", dest="width", type=int, default=512)
    p.add_argument("-M", dest="matcap", default=None, help="matcap PNG (enables matcap shading)")
    p.add_argument("-rx", dest="rx", type=float, default=0.0)
    p.add_argument("-ry", dest="ry", type=float, default=0.0)
    p.add_argument("-rz", dest="rz", type=float, default=0.0,
                   help="accepted for reference parity; orbit camera ignores it")
    p.add_argument("-z", dest="zoom", type=float, default=2.0)
    p.add_argument("--single", action="store_true", help="render one frame and exit")
    p.add_argument("--spin", action="store_true", help="360-frame turntable")
    p.add_argument("--animation", action="store_true", help="4-input (x,y,z,frame) mode")
    # framework extensions
    p.add_argument("--scene", default=None,
                   help="scene composition (default: neural_raw; reference ships many_sphere)")
    p.add_argument("--steps", type=int, default=6000, help="max march steps")
    p.add_argument("--march", choices=("while", "fori", "staged"), default="staged")
    p.add_argument("--normal-mode", choices=("autodiff", "tetrahedron"), default="autodiff")
    p.add_argument("--warm-start", action="store_true",
                   help="turntable: chain each frame's surface depths into "
                        "the next frame's march init (temporal warm start — "
                        "an approximation near silhouettes; see "
                        "RenderConfig.warm_margin)")
    p.add_argument("--parity-flip", action="store_true",
                   help="reproduce the reference's 180° savePNG orientation")
    p.add_argument("--serve", action="store_true",
                   help="interactive browser viewer (GLUT-window equivalent)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--save-ckpt", default=None, help="re-save loaded weights as .npz")
    p.add_argument("--stats", action="store_true",
                   help="print a JSON line of per-frame render stats (steps, "
                        "hits, compaction health, ms)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the render into DIR "
                        "(view with TensorBoard/XProf)")
    p.add_argument("--fault-inject", type=int, default=0, metavar="N",
                   help="debug: render through the fault-tolerant band path "
                        "and inject N transient band failures (exercises "
                        "tile retry; parallel/fault.py)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import cudaneuralrender as cnr
    from cudaneuralrender.utils import image_io

    params = cnr.load(args.input)
    print(f"Model initialized... ({cnr.mlp.num_params(params)} params, "
          f"layers {cnr.mlp.layer_sizes(params)})")

    if args.save_ckpt:
        cnr.save_pytree(args.save_ckpt, params)
        print(f"saved checkpoint: {args.save_ckpt}")

    matcap = None
    shading = "facing"
    if args.matcap:
        matcap = image_io.load_matcap(args.matcap)
        shading = "matcap"

    num_inputs = 4 if args.animation else 3
    from cudaneuralrender.models import mlp as mlp_lib

    model_in = mlp_lib.layer_sizes(params)[0]
    if model_in != num_inputs:
        # Clear early error instead of an opaque dot-shape failure deep in
        # the MLP (the reference aborts on denseLayer.cu:230's assert in
        # the same situation). All the reference-shipped .h5s are 3-input;
        # examples/train_animated.py trains a 4-input (x,y,z,frame) model.
        if num_inputs == 4:
            detail = "--animation needs a 4-input (x,y,z,frame) model"
        else:
            detail = "this model is 4-input — pass --animation"
        print(
            f"error: model {args.input!r} expects {model_in} inputs; "
            f"{detail} (train one with examples/train_animated.py)",
            file=sys.stderr,
        )
        return 2

    cfg = cnr.RenderConfig(
        width=args.width,
        height=args.height,
        max_steps=args.steps,
        scene=args.scene or "neural_raw",
        shading=shading,
        normal_mode=args.normal_mode,
        num_inputs=num_inputs,
        march_impl=args.march,
    ).validate()

    renderer = cnr.Renderer(params, cfg, matcap)
    camera = cnr.Camera.from_cli(rx=args.rx, ry=args.ry, zoom=args.zoom)
    out_prefix = args.output or args.input

    if args.serve:
        from cudaneuralrender.render.viewer import serve

        serve(renderer, camera, port=args.port)
        return 0

    def render_one(cam, frame, path):
        t0 = time.perf_counter()
        if args.fault_inject:
            from cudaneuralrender.parallel import fault

            inj = fault.FaultInjector(fail_times=args.fault_inject)
            rgba = fault.render_tiled(
                params, cam, cfg, renderer.matcap, frame, injector=inj
            )
            print(f"fault drill: {inj.injected} injected failures recovered")
        elif args.profile:
            with jax.profiler.trace(args.profile):
                rgba = renderer.render(cam, frame)
                jax.block_until_ready(rgba)
        else:
            rgba = renderer.render(cam, frame)
            jax.block_until_ready(rgba)
        dt = time.perf_counter() - t0
        if args.stats:
            import json

            print(json.dumps({"frame": frame, "ms": round(dt * 1e3, 2),
                              **renderer.last_stats}), flush=True)
        img = image_io.to_uint8_image(np.asarray(rgba), parity_flip=args.parity_flip)
        if path.lower().endswith(".ppm"):
            image_io.save_ppm(path, img)
        else:
            image_io.save_png(path, img)
        print(f"saving frame: {path}")
        return dt

    if args.spin:
        # Turntable (doABarrelRoll, main.cpp:470-478): 360 frames stepping
        # both the camera yaw and the animation frame number. Staged configs
        # render pipelined in chunks (render_sequence: one host sync per
        # chunk instead of per frame).
        times = []
        if cfg.march_impl == "staged":
            # Resume semantics (the reference numbers frames and a rerun
            # overwrites; we skip frames already on disk so an interrupted
            # turntable continues where it stopped — SURVEY.md §5
            # checkpoint/resume row).
            todo = [
                i for i in range(360)
                if not os.path.exists(f"{out_prefix}_{i:03d}.png")
            ]
            if len(todo) < 360:
                print(f"turntable resume: {360 - len(todo)} frames already on disk")
            chunk = 24
            for start in range(0, len(todo), chunk):
                idxs = todo[start:start + chunk]
                cams = [
                    cnr.Camera.from_cli(rx=args.rx, ry=float(i), zoom=args.zoom)
                    for i in idxs
                ]
                t0 = time.perf_counter()
                rgbas = cnr.render_sequence(
                    params, cams, cfg, renderer.matcap,
                    frames=[float(i) for i in idxs],
                    warm_start=args.warm_start,
                )
                times.append((time.perf_counter() - t0) / len(idxs))
                for i, rgba in zip(idxs, rgbas):
                    img = image_io.to_uint8_image(
                        np.asarray(rgba), parity_flip=args.parity_flip
                    )
                    image_io.save_png(f"{out_prefix}_{i:03d}.png", img)
            mean_s = float(np.mean(times[1:])) if len(times) > 1 else 0.0
            print(
                f"turntable done: 360 frames, mean {mean_s:.3f}s/frame"
                " (pipelined)"
            )
            return 0
        for i in range(360):
            cam = cnr.Camera.from_cli(rx=args.rx, ry=float(i), zoom=args.zoom)
            path = f"{out_prefix}_{i:03d}.png"
            times.append(render_one(cam, float(i), path))
        print(f"turntable done: 360 frames, mean {np.mean(times[1:]):.3f}s/frame")
        return 0

    # Single frame (generateSingleImage, main.cpp:404-468).
    base = os.path.basename(args.input)
    path = out_prefix if args.output else f"{base}.png"
    dt = render_one(camera, 0.0, path)
    n_tex = args.width * args.height
    # Reference throughput line format (main.cpp:434-438).
    print(
        "volumeRender, Throughput = %.4f MTexels/s, Time = %.5f s, Size = %u Texels, "
        "NumDevsUsed = %u, Workgroup = %u"
        % (1.0e-6 * n_tex / dt, dt, n_tex, len(jax.devices()), 0)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
