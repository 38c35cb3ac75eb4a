"""Train a 4-input (x, y, z, frame) animated neural SDF — the model family
behind the reference's `--animation` mode.

The reference supports 4-input networks (c_numInputs==4 appends the frame
number to every sample — createBatch, volumeRender_kernel.cu:533-544) but
ships no 4-input geometry. This example closes that gap natively: it fits a
4-input MLP to a time-morphing analytic scene (sphere orbiting a rounded
box, frame in [0, 360) like the turntable counter), saves the checkpoint,
and renders a few animation frames with num_inputs=4.

Usage: python examples/train_animated.py [--steps 3000] [--out /tmp/anim_demo]
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


def target_sdf(p: jax.Array, frame: jax.Array) -> jax.Array:
    """Frame-animated scene: a small sphere orbits a rounded box, smoothly
    unioned (frame convention matches the reference's 0..359 counter)."""
    ang = frame * (2.0 * jnp.pi / 360.0)
    center = 0.6 * jnp.stack([jnp.cos(ang), jnp.zeros_like(ang), jnp.sin(ang)], -1)
    body = sdf.box(p, (0.35, 0.25, 0.35), round_radius=0.05)
    orb = sdf.sphere(p - center, 0.18)
    return sdf.smooth_union(body, orb, 0.08)


def sample(key, n):
    kp, kf = jax.random.split(key)
    pts = jax.random.uniform(kp, (n, 3), minval=-1.1, maxval=1.1)
    frames = jax.random.uniform(kf, (n,), minval=0.0, maxval=360.0)
    x = jnp.concatenate([pts, frames[:, None] / 360.0 * 2.0 - 1.0], axis=-1)
    return x, target_sdf(pts, frames)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default="/tmp/anim_demo")
    ap.add_argument("--render", type=int, default=192)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()

    params = mlp.init_mlp(
        jax.random.key(0), sizes=(4, 32, 32, 32, 32, 32, 32, 32, 32, 1)
    )
    params, hist = train.fit_sdf(
        params, sample, steps=args.steps, batch=args.batch, lr=args.lr
    )
    print(f"trained {args.steps} steps: loss {hist[0]:.4f} -> {hist[-1]:.6f}")
    ckpt = f"{args.out}.npz"
    cnr.save_pytree(ckpt, params)
    print(f"saved checkpoint: {ckpt}")
    from cudaneuralrender.models import checkpoint as ckpt_lib

    ckpt_lib.save_keras_h5(f"{args.out}.h5", params)
    print(f"saved Keras-layout checkpoint: {args.out}.h5")
    # examples/assets/anim_demo.h5 in the repo is this file — the ONLY
    # 4-input (x,y,z,frame) geometry in the tree (every reference-shipped
    # .h5 is 3-input), so the CLI's --animation mode has a renderable
    # model end-to-end (tests/test_artifact.py).

    # NOTE the frame normalization: the renderer feeds the raw frame number
    # (reference parity); this model was trained on frame/180 - 1, so we
    # render through a RenderConfig with num_inputs=4 and pre-scaled frames.
    cfg = cnr.RenderConfig(width=args.render, height=args.render,
                           scene="neural_raw", num_inputs=4, max_steps=400)
    cam = cnr.Camera(rotation_y=20.0, rotation_x=-25.0)
    for i in range(args.frames):
        frame = i * (360.0 / args.frames)
        img = cnr.render_staged(params, cam, cfg, frame=frame / 180.0 - 1.0)
        png = f"{args.out}_{i:03d}.png"
        image_io.save_png(png, image_io.to_uint8_image(np.asarray(img)))
        print(f"rendered frame {frame:.0f}: {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
