"""Train a neural SDF from scratch and render it — what the reference's
Keras pipeline did offline (its .h5 geometries were trained externally;
SURVEY.md §0), now done natively by the framework's differentiable stack.

Fits the reference architecture (9 dense layers, 3->32x8->1, ReLU hidden —
neuralNetwork.cpp:136-139 semantics) to an analytic CSG target by SDF
distillation + eikonal regularization, saves the weights as an .npz pytree
checkpoint, and renders a turntable frame.

Usage: python examples/train_sdf.py [--steps 2000] [--out /tmp/csg_demo]
"""
from __future__ import annotations

import argparse
import sys

import os as _os

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.diff import train
from cudaneuralrender.models import mlp
from cudaneuralrender.ops import sdf
from cudaneuralrender.utils import image_io


def target_sdf(p: jax.Array) -> jax.Array:
    """Rounded box with a sphere bite — exercises union/subtract/round."""
    body = sdf.box(p, (0.5, 0.3, 0.4), round_radius=0.1)
    bite = sdf.sphere(p - jnp.asarray([0.4, 0.3, 0.3]), 0.35)
    return sdf.subtract(body, bite)


def sample(key, n):
    pts = jax.random.uniform(key, (n, 3), minval=-1.1, maxval=1.1)
    return pts, target_sdf(pts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default="/tmp/csg_demo")
    ap.add_argument("--render", type=int, default=256)
    args = ap.parse_args()

    params = mlp.init_mlp(jax.random.key(0))
    params, hist = train.fit_sdf(
        params, sample, steps=args.steps, batch=args.batch, lr=args.lr
    )
    print(f"trained {args.steps} steps: loss {hist[0]:.4f} -> {hist[-1]:.6f}")

    ckpt = f"{args.out}.npz"
    cnr.save_pytree(ckpt, params)
    print(f"saved checkpoint: {ckpt}")
    # Keras-layout twin: the format every pipeline entry point (CLI,
    # viewer, sharded render — and the CUDA reference's own loader)
    # consumes. examples/assets/csg_demo.h5 in the repo is this file,
    # committed together with its golden render (tests/test_artifact.py).
    from cudaneuralrender.models import checkpoint as ckpt_lib

    ckpt_lib.save_keras_h5(f"{args.out}.h5", params)
    print(f"saved Keras-layout checkpoint: {args.out}.h5")

    cfg = cnr.RenderConfig(width=args.render, height=args.render,
                           scene="neural_raw", max_steps=500)
    img = cnr.render_staged(params, cnr.Camera(rotation_y=30.0, rotation_x=-20.0), cfg)
    png = f"{args.out}.png"
    image_io.save_png(png, image_io.to_uint8_image(np.asarray(img)))
    print(f"rendered: {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
