"""Property test: compaction schedules are performance hints, NEVER
correctness hazards (the staged scheduler's core contract,
render/renderer.py::_run_schedule docstring).

Random schedules — under-provisioned buckets, zero-step rungs, absurd
divisors, tiny compact_min — must all produce the same surface as the
dense reference march in march_precision="full" (exact reference
semantics: HIGHEST everywhere, no mixed-precision tolerance), via the
overflow/continuation machinery when the schedule itself is hopeless.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import cudaneuralrender as cnr


def _random_schedule(rng):
    n_rungs = int(rng.integers(1, 5))
    rungs = []
    for _ in range(n_rungs):
        div = int(2 ** rng.integers(0, 11))  # 1 .. 1024
        steps = int(rng.choice([0, 1, 2, 4, 8, 16, 64]))
        rungs.append((div, steps))
    if rng.random() < 0.7:
        rungs[-1] = (rungs[-1][0], 0)  # usually end run-to-dry
    return tuple(rungs)


@pytest.mark.parametrize("seed", range(8))
def test_random_schedules_never_change_the_surface(plane1_params, seed):
    rng = np.random.default_rng(seed)
    sched = _random_schedule(rng)
    cfg = cnr.RenderConfig(
        width=24, height=24, scene="neural_raw", max_steps=300,
        march_impl="staged", march_precision="full",
        fine_schedule=sched,
        compact_min=int(rng.choice([4, 16, 2048])),
        shade_div=int(rng.choice([2, 8, 64])),
        rgba_packed=False,
    )
    cam = cnr.Camera(rotation_y=float(rng.uniform(0, 360)),
                     rotation_x=float(rng.uniform(-30, 30)))
    cnr.reset_schedule_memo()
    staged = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    dense = np.asarray(cnr.render_image(
        plane1_params, cam, cfg.replace(march_impl="while")))
    np.testing.assert_allclose(staged, dense, atol=1e-5,
                               err_msg=f"schedule {sched}")
    cnr.reset_schedule_memo()


@pytest.mark.parametrize("seed", range(4))
def test_random_mixed_schedules_keep_silhouette(plane1_params, seed):
    """Mixed precision: random refine/mid ladders must stay within the
    documented silhouette-level tolerance of the default schedule."""
    rng = np.random.default_rng(100 + seed)
    cfg = cnr.RenderConfig(
        width=24, height=24, scene="neural_raw", max_steps=300,
        march_impl="staged",
        refine_schedule=_random_schedule(rng),
        mid_eps=float(rng.choice([0.0, 1e-3])),
        mid_schedule=_random_schedule(rng) if rng.random() < 0.5 else (),
        compact_min=int(rng.choice([4, 2048])),
    )
    cam = cnr.Camera(rotation_y=float(rng.uniform(0, 360)))
    cnr.reset_schedule_memo()
    a = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    b = np.asarray(cnr.render_staged(
        plane1_params, cam,
        cnr.RenderConfig(width=24, height=24, scene="neural_raw",
                         max_steps=300, march_impl="staged")))
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() > 0.98, "silhouette drifted"
    cnr.reset_schedule_memo()


@pytest.mark.parametrize("seed", range(6))
def test_random_refine_caps_never_change_the_surface(plane1_params, seed):
    """Adaptive rung caps obey the same contract as every schedule knob:
    RANDOM explicit caps — hopelessly tiny, absurdly large, non-monotone
    in provisioning — must render the same image as the divisor-default
    mixed path for the same config, via the overflow/retune machinery
    when the caps themselves are hopeless (round-5 feature hardening)."""
    rng = np.random.default_rng(500 + seed)
    base = cnr.RenderConfig(
        width=24, height=24, scene="neural_raw", max_steps=300,
        march_impl="staged", compact_min=int(rng.choice([4, 16, 64])),
        adaptive_rungs=bool(rng.random() < 0.5),
    )
    n = base.num_rays
    caps = []
    prev = n
    for _ in base.refine_schedule:
        c = int(rng.choice([1, 8, 37, 200, n // 3, n, 4 * n]))
        caps.append(max(1, min(c, prev)))  # non-increasing (validate-free)
        prev = caps[-1]
    capped = base.replace(refine_caps=tuple(caps))
    cam = cnr.Camera(rotation_y=float(rng.uniform(0, 360)),
                     rotation_x=float(rng.uniform(-30, 30)))
    cnr.reset_schedule_memo()
    a = np.asarray(cnr.render_staged(plane1_params, cam, capped))
    cnr.reset_schedule_memo()
    b = np.asarray(cnr.render_staged(
        plane1_params, cam, base.replace(adaptive_rungs=False)))
    same = np.all(a == b, axis=-1)
    assert same.mean() >= 0.995, (caps, same.mean())
    cnr.reset_schedule_memo()
