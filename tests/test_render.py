"""End-to-end render tests: analytic scene geometry checks + real-model smoke
renders + staged-compaction equivalence (BASELINE config 1 machinery)."""
import numpy as np
import jax.numpy as jnp
import pytest

import cudaneuralrender as cnr


ANALYTIC_CFG = cnr.RenderConfig(
    width=64, height=64, scene="sphere", max_steps=200, march_eps=1e-5
)


def test_render_analytic_sphere_silhouette():
    """A 0.9-radius sphere from distance 2 with focal 2: the silhouette
    half-angle is asin(0.9/2) -> tan gives the NDC radius; check the rendered
    alpha mask matches the analytic disc within a pixel."""
    img = np.asarray(cnr.render_image(None, cnr.Camera(), ANALYTIC_CFG))
    assert img.shape == (64, 64, 4)
    alpha = img[..., 3] > 0
    ys, xs = np.nonzero(alpha)
    assert len(xs) > 0
    # center of image
    cx, cy = xs.mean(), ys.mean()
    assert abs(cx - 31.5) < 1.0 and abs(cy - 31.5) < 1.0
    # radius in NDC: direction angle theta with sin(theta) = 0.9/2
    sin_t = 0.9 / 2.0
    tan_t = sin_t / np.sqrt(1 - sin_t**2)
    ndc_r = tan_t * 2.0  # u at which the ray grazes: u/focal = tan -> u = 2 tan
    pix_r = ndc_r / 2.0 * 64
    got_r = np.sqrt(alpha.sum() / np.pi)
    assert abs(got_r - pix_r) < 1.5


def test_render_shading_is_lambert_like():
    """Facing-ratio at the silhouette center equals 1 (normal facing camera)."""
    img = np.asarray(cnr.render_image(None, cnr.Camera(), ANALYTIC_CFG))
    center = img[32, 32]
    np.testing.assert_allclose(center, [1, 1, 1, 1], atol=1e-2)


def test_render_rotation_invariance_of_sphere():
    """A centered sphere renders identically under y-rotation."""
    a = np.asarray(cnr.render_image(None, cnr.Camera(), ANALYTIC_CFG))
    b = np.asarray(cnr.render_image(None, cnr.Camera(rotation_y=90.0), ANALYTIC_CFG))
    np.testing.assert_allclose(a[..., 3], b[..., 3], atol=1e-5)


def test_render_plane1_smoke(plane1_params):
    """Real-model render at 64² on CPU: must produce a nonempty, non-full
    foreground and finite colors (BASELINE config 1 reduced)."""
    cfg = cnr.RenderConfig(width=64, height=64, scene="neural_raw", max_steps=300)
    img = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), cfg))
    assert np.isfinite(img).all()
    fg = (img[..., 3] > 0).mean()
    assert 0.02 < fg < 0.9, f"foreground fraction {fg}"


def test_staged_full_precision_matches_dense(csg_params):
    """march_precision='full' is the reference-semantics contract: the same
    march ordering as the dense path (no grid skip, no coarse phase, HIGHEST
    matmuls). The staged path recomputes the budget from (pos, t) per bucket
    (see PackedRays), a different f32 summation order than the dense carried
    chain, so borderline budget<=0 decisions may flip on isolated silhouette
    pixels — hits must agree everywhere but a sliver, and common-hit pixels
    must match tightly."""
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300)
    dense = np.asarray(cnr.render_image(csg_params, cnr.Camera(), cfg))
    staged = np.asarray(
        cnr.render_staged(
            csg_params, cnr.Camera(),
            cfg.replace(march_impl="staged", stage_steps=16, march_precision="full",
                        rgba_packed=False),
        )
    )
    hit_d = dense[..., 3] > 0
    hit_s = staged[..., 3] > 0
    agree = (hit_d == hit_s).mean()
    assert agree >= 0.999, f"hit agreement {agree}"
    both = hit_d & hit_s
    np.testing.assert_allclose(staged[both], dense[both], atol=1e-4)


def test_staged_mixed_matches_dense_structurally(csg_params):
    """The default mixed path (grid skip + precision ladder) is allowed
    silhouette-level wobble only: hits agree and common-hit colors match.
    Seen from csg_demo's golden camera (tests/test_artifact.py)."""
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=-20.0)
    dense = np.asarray(cnr.render_image(csg_params, cam, cfg))
    staged = np.asarray(
        cnr.render_staged(csg_params, cam,
                          cfg.replace(march_impl="staged", rgba_packed=False))
    )
    hit_d = dense[..., 3] > 0
    hit_s = staged[..., 3] > 0
    agree = (hit_d == hit_s).mean()
    assert agree >= 0.99, f"hit agreement {agree}"
    both = hit_d & hit_s
    close = np.all(np.abs(staged[both] - dense[both]) < 1e-3, axis=-1).mean()
    # sub-pixel-thin features may converge on a different surface sheet
    assert close >= 0.97, f"only {close:.3f} of common hits match"


def test_render_matcap_mode(plane1_params, matcap_path):
    from cudaneuralrender.utils import image_io

    matcap = jnp.asarray(image_io.load_matcap(matcap_path))
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=200, shading="matcap")
    img = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), cfg, matcap))
    assert np.isfinite(img).all()
    fg = img[..., 3] > 0
    assert fg.any()
    # matcap texels must not be all gray (chrome has color variation)
    px = img[fg]
    assert px[:, :3].std() > 0.01


def test_renderer_class_and_save(tmp_path, plane1_params):
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=200)
    r = cnr.Renderer(plane1_params, cfg)
    frame = r.render_frame(cnr.Camera())
    assert frame.shape == (32, 32, 4) and frame.dtype == np.uint8
    png = tmp_path / "out.png"
    ppm = tmp_path / "out.ppm"
    r.save_frame(str(png), cnr.Camera())
    r.save_frame(str(ppm), cnr.Camera())
    from cudaneuralrender.utils import image_io

    np.testing.assert_array_equal(image_io.load_png(str(png)), frame)
    np.testing.assert_array_equal(image_io.load_ppm(str(ppm)), frame[..., :3])


def test_animation_mode_changes_scene(plane1_params):
    cfg = cnr.RenderConfig(width=32, height=32, scene="many_sphere", max_steps=200)
    a = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), cfg, frame=0.0))
    b = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), cfg, frame=180.0))
    assert not np.allclose(a, b)


def test_tetrahedron_normal_mode_close_to_autodiff(plane1_params):
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=200)
    ad = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), cfg))
    fd = np.asarray(
        cnr.render_image(plane1_params, cnr.Camera(), cfg.replace(normal_mode="tetrahedron"))
    )
    mask = ad[..., 3] > 0
    assert np.abs(ad[mask] - fd[mask]).mean() < 0.02


def test_render_sequence_matches_staged(plane1_params):
    """Pipelined multi-frame rendering must be bit-identical to per-frame
    render_staged (same compiled program, one deferred stats sync)."""
    cfg = cnr.RenderConfig(width=48, height=48, scene="neural_raw", max_steps=300,
                           march_impl="staged")
    cams = [cnr.Camera(rotation_y=float(r)) for r in (0.0, 40.0, 80.0)]
    stats = []
    outs = cnr.render_sequence(plane1_params, cams, cfg, stats_out=stats)
    assert len(outs) == 3 and len(stats) == 3
    for cam, out, st in zip(cams, outs, stats):
        ref = cnr.render_staged(plane1_params, cam, cfg)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
        assert st["rays"] == 48 * 48


def test_staged_mid_eps_phase(plane1_params):
    """The optional HIGH middle ladder phase (mid_eps) must agree with the
    two-phase mixed path (on the GPU its HIGH phase runs TF32; on CPU every
    precision is f32, so images should be very close)."""
    from cudaneuralrender.render import renderer

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=256, march_impl="staged", rgba_packed=False)
    a = np.asarray(renderer.render_staged(plane1_params, cnr.Camera(), cfg))
    b = np.asarray(renderer.render_staged(
        plane1_params, cnr.Camera(), cfg.replace(mid_eps=1e-3)))
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() > 0.99
    both = hit_a & hit_b
    np.testing.assert_allclose(a[both], b[both], atol=1e-3)


def test_staged_coarse_high_precision(plane1_params):
    """coarse_precision="high" (emulated 3-pass coarse kernel to a tighter
    eps) must agree with the default coarse phase (CPU: both exact f32)."""
    from cudaneuralrender.render import renderer

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=256, march_impl="staged", rgba_packed=False)
    a = np.asarray(renderer.render_staged(plane1_params, cnr.Camera(), cfg))
    b = np.asarray(renderer.render_staged(
        plane1_params, cnr.Camera(),
        cfg.replace(coarse_precision="high", coarse_eps=1e-3)))
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() > 0.99
    both = hit_a & hit_b
    np.testing.assert_allclose(a[both], b[both], atol=1e-3)


def test_rgba_packed_is_exact_u8_quantization(plane1_params):
    """Default staged output (rgba_packed=True) must equal the f32 render
    quantized through the reference's u8 display format (rgbaFloatToInt,
    volumeRender_kernel.cu:266-274): saturate, x255, truncate, /255. The
    saved PNG bytes are therefore identical either way."""
    from cudaneuralrender.utils import image_io

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=300, march_impl="staged")
    packed = np.asarray(cnr.render_staged(plane1_params, cnr.Camera(), cfg))
    exact = np.asarray(cnr.render_staged(
        plane1_params, cnr.Camera(), cfg.replace(rgba_packed=False)))
    quantized = np.clip(exact, 0.0, 1.0)
    quantized = (quantized * 255.0).astype(np.uint8).astype(np.float32) \
        * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(packed, quantized)
    np.testing.assert_array_equal(
        image_io.to_uint8_image(packed), image_io.to_uint8_image(exact)
    )


def test_refine_overflow_widens_buckets(plane1_params):
    """An under-provisioned refine bucket (tiny compact_min + huge div) must
    trigger the overflow fallback — retry with doubled buckets — and still
    produce the same image as a safely-provisioned schedule."""
    safe = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                            max_steps=300, march_impl="staged")
    tiny = safe.replace(refine_schedule=((1024, 4), (1024, 0)), compact_min=8)
    stats = {}
    img_tiny = np.asarray(cnr.render_staged(
        plane1_params, cnr.Camera(), tiny, stats_out=stats))
    img_safe = np.asarray(cnr.render_staged(plane1_params, cnr.Camera(), safe))
    assert not stats.get("fast_path", True), "overflow fallback should trigger"
    hit_a, hit_b = img_tiny[..., 3] > 0, img_safe[..., 3] > 0
    assert (hit_a == hit_b).mean() > 0.99


def test_render_sequence_warm_start(plane1_params):
    """Temporal warm start (render_sequence(warm_start=True)): each frame
    starts rays just short of the previous frame's surface
    (RenderConfig.warm_margin). On a 1-deg-apart orbit the result must agree
    with the cold render except silhouette-level noise: near-exact hit mask
    and identical colors on the vast majority of pixels. Frame 0 has no
    predecessor, so it must be bit-identical to cold."""
    cfg = cnr.RenderConfig(width=48, height=48, scene="neural_raw",
                           max_steps=300, march_impl="staged")
    cams = [cnr.Camera(rotation_x=10.0, rotation_y=30.0 + float(i))
            for i in range(3)]
    cold = cnr.render_sequence(plane1_params, cams, cfg)
    warm = cnr.render_sequence(plane1_params, cams, cfg, warm_start=True)

    np.testing.assert_array_equal(np.asarray(warm[0]), np.asarray(cold[0]))
    for c, w in zip(cold[1:], warm[1:]):
        c, w = np.asarray(c), np.asarray(w)
        hit_c, hit_w = c[..., 3] > 0, w[..., 3] > 0
        assert (hit_c == hit_w).mean() > 0.995
        assert np.all(c == w, axis=-1).mean() > 0.98


def test_warm_init_state_guard_semantics():
    """march.init_state warm lanes: t clipped to [tnear, tfar], budget keeps
    the reference invariant budget == tfar - (t - tnear); non-finite /
    non-positive t_init lanes stay cold."""
    import jax.numpy as jnp
    from cudaneuralrender.ops import march

    origin = jnp.asarray([0.0, 0.0, -2.0])
    dirs = jnp.asarray([[0.0, 0.0, 1.0]] * 4)
    t_init = jnp.asarray([1.5, -jnp.inf, 0.0, 100.0])
    warm = march.init_state(origin, dirs, (0, 0, 0), 1.2, t_init=t_init,
                            warm_margin=0.1)
    cold = march.init_state(origin, dirs, (0, 0, 0), 1.2)
    tnear, tfar, _ = march.intersect_sphere(origin, dirs, (0, 0, 0), 1.2)
    tnear = jnp.maximum(tnear, 0.0)

    # lane 0: warm at t_init - margin
    np.testing.assert_allclose(float(warm.t[0]), 1.4, rtol=1e-6)
    np.testing.assert_allclose(
        float(warm.budget[0]), float(tfar[0] - (1.4 - tnear[0])), rtol=1e-6)
    # lanes 1-2: no suggestion -> cold
    np.testing.assert_array_equal(np.asarray(warm.t[1:3]), np.asarray(cold.t[1:3]))
    np.testing.assert_array_equal(
        np.asarray(warm.budget[1:3]), np.asarray(cold.budget[1:3]))
    # lane 3: clipped to tfar
    np.testing.assert_allclose(float(warm.t[3]), float(tfar[3]), rtol=1e-6)


def test_render_sequence_warm_start_block_order(plane1_params):
    """Warm start across a REAL block permutation (coarse_block smaller than
    the image): the producer emits the state in block-major lane order and
    the consumer must interpret it in the same order — a mismatch would warm
    the wrong pixels and wreck the hit mask."""
    cfg = cnr.RenderConfig(width=48, height=48, scene="neural_raw",
                           max_steps=300, march_impl="staged",
                           coarse_block=(16, 16))
    cams = [cnr.Camera(rotation_x=10.0, rotation_y=30.0 + float(i))
            for i in range(3)]
    cold = cnr.render_sequence(plane1_params, cams, cfg)
    warm = cnr.render_sequence(plane1_params, cams, cfg, warm_start=True)
    for c, w in zip(cold[1:], warm[1:]):
        c, w = np.asarray(c), np.asarray(w)
        hit_c, hit_w = c[..., 3] > 0, w[..., 3] > 0
        assert (hit_c == hit_w).mean() > 0.995
        assert np.all(c == w, axis=-1).mean() > 0.98


def test_overflow_widen_consistent_across_entry_points(plane1_params):
    """A mid-ladder overflow must teach the SAME widened schedule through
    every staged entry point (render_staged, render_sequence,
    multigeom.render_batch_staged, solve_surface) — the fast-path/widening
    logic is one shared helper, not four drifting copies (round-3 VERDICT
    weak #5). mid_eps>0 makes the HIGH mid phase real so its schedule's
    widening is exercised too."""
    from cudaneuralrender.diff.solve import solve_surface
    from cudaneuralrender.render import multigeom
    from cudaneuralrender.render import renderer as renderer_lib

    base = cnr.RenderConfig(
        width=32, height=32, scene="neural_raw", max_steps=300,
        march_impl="staged", compact_min=8,
        refine_schedule=((1024, 4), (1024, 0)),
        mid_eps=1e-3, mid_schedule=((1024, 8), (1024, 0)),
    )
    cam = cnr.Camera()
    learned = []

    def run(entry):
        cnr.reset_schedule_memo()
        entry()
        learned.append(renderer_lib.memo_lookup(plane1_params, base))

    run(lambda: cnr.render_staged(plane1_params, cam, base))
    run(lambda: cnr.render_sequence(plane1_params, [cam], base))
    run(lambda: multigeom.render_batch_staged([plane1_params], cam, base))
    run(lambda: solve_surface(plane1_params, cam, base))
    cnr.reset_schedule_memo()

    assert all(w == learned[0] for w in learned), learned
    assert learned[0] != base, "overflow should have taught a widened config"
    # Recovery is the ONE shared helper (_widen_or_retune): the HIGHEST
    # ladder re-fits via stats-sized caps, and the HIGH mid ladder (which
    # caps don't govern) widens by divisor halving.
    assert learned[0].refine_caps, learned[0]
    assert learned[0].mid_schedule[0][0] < base.mid_schedule[0][0]


def test_render_sequence_overflow_widens_once(csg_params):
    """Several poses that all overflow the first refine bucket re-render
    with ONE widened schedule sized from their largest rung counts (one
    compiled program for the batch), which the memo learns; each frame
    equals render_staged with that schedule."""
    from cudaneuralrender.render import renderer as renderer_lib

    base = cnr.RenderConfig(
        width=32, height=32, scene="neural_raw", max_steps=300,
        march_impl="staged", compact_min=8, rgba_packed=False,
        refine_schedule=((1024, 4), (1024, 0)),
    )
    cams = [cnr.Camera(rotation_y=30.0 + 20.0 * i, rotation_x=-20.0) for i in range(3)]
    cnr.reset_schedule_memo()
    try:
        stats = []
        outs = cnr.render_sequence(csg_params, cams, base, stats_out=stats)
        assert all(s["refine_overflow"] > 0 for s in stats), stats
        widened = renderer_lib.memo_lookup(csg_params, base)
        assert widened != base and widened.refine_caps, widened
        for cam, out in zip(cams, outs):
            want = cnr.render_staged(csg_params, cam, widened)
            np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    finally:
        cnr.reset_schedule_memo()

def test_schedule_memo_keyed_by_geometry(plane1_params, car1_path):
    """Two geometries sharing one config must not share one memo slot: a
    widened schedule learned for geometry A must not redirect geometry B
    (round-3 VERDICT weak #6)."""
    from cudaneuralrender.models import checkpoint
    from cudaneuralrender.render import renderer as renderer_lib
    from cudaneuralrender.utils import memo as memo_store

    car = checkpoint.load(car1_path)
    memo_store.tag_geometry(plane1_params, "plane_1.h5")
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=300, march_impl="staged")
    cnr.reset_schedule_memo()
    widened = renderer_lib._widen(cfg)
    renderer_lib.memo_teach(plane1_params, cfg, widened)
    assert renderer_lib.memo_lookup(plane1_params, cfg) == widened
    assert renderer_lib.memo_lookup(car, cfg) == cfg
    cnr.reset_schedule_memo()


def test_schedule_memo_persists_across_processes(tmp_path, monkeypatch,
                                                 plane1_path):
    """A widened schedule learned for a TAGGED geometry must be readable by
    a fresh process (simulated by clearing the in-process memo + store
    cache): the overflow double-render is paid once, ever (round-3 VERDICT
    item 8)."""
    from cudaneuralrender.models import checkpoint
    from cudaneuralrender.render import renderer as renderer_lib

    store = tmp_path / "schedmemo.json"
    monkeypatch.setenv("CNR_SCHEDULE_MEMO", str(store))
    cnr.reset_schedule_memo()

    params = checkpoint.load(plane1_path)  # load() tags with the basename
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=300, march_impl="staged")
    widened = renderer_lib._widen(cfg)
    renderer_lib.memo_teach(params, cfg, widened)
    assert store.exists()

    # "New process": in-memory memo gone, store cache dropped; the persisted
    # entry must reconstruct the widened config (schedules are the only
    # fields that differ).
    cnr.reset_schedule_memo()
    got = renderer_lib.memo_lookup(params, cfg)
    assert got == widened

    # A different config must not match the persisted key.
    other = cfg.replace(max_steps=400)
    assert renderer_lib.memo_lookup(params, other) == other
    cnr.reset_schedule_memo()


def test_adaptive_caps_learned_and_parity(plane1_params):
    """Adaptive rung sizing (round-4 VERDICT item 1): a successful staged
    frame's per-rung stats teach SHRUNKEN explicit caps through the memo
    (the memo now shrinks schedules, not only widens them); the tuned
    dispatch is pixel-identical, caps never exceed the divisor defaults,
    and they are non-increasing down the ladder (rung i sorts within rung
    i-1's bucket)."""
    from cudaneuralrender.render import renderer as renderer_lib

    cnr.reset_schedule_memo()
    cfg = cnr.RenderConfig(width=128, height=128, scene="neural_raw",
                           max_steps=600, march_impl="staged",
                           compact_min=256)
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    a = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    tuned = renderer_lib.memo_lookup(plane1_params, cfg)
    assert tuned.refine_caps, "fast frame should teach tuned caps"
    n = cfg.num_rays
    shrunk = False
    for (div, _s), c in zip(cfg.refine_schedule, tuned.refine_caps):
        base = max(n // div, cfg.compact_min)
        assert c <= base
        shrunk = shrunk or c < base
    assert shrunk, tuned.refine_caps
    caps = tuned.refine_caps
    assert all(b <= a2 for a2, b in zip(caps, caps[1:])), caps
    b = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    np.testing.assert_array_equal(a, b)
    cnr.reset_schedule_memo()


def test_adaptive_caps_overflow_retunes(plane1_params):
    """Caps a frame outgrows raise the refine-overflow retry, which RESIZES
    them from the overflowing frame's own recorded rung stats
    (renderer._widen_or_retune) — one retry, correct image, memo taught."""
    from cudaneuralrender.render import renderer as renderer_lib

    cnr.reset_schedule_memo()
    base = cnr.RenderConfig(width=64, height=64, scene="neural_raw",
                            max_steps=300, march_impl="staged",
                            compact_min=8)
    tiny = base.replace(refine_caps=(16, 16, 16, 8))
    cam = cnr.Camera()
    stats = {}
    img = np.asarray(cnr.render_staged(plane1_params, cam, tiny,
                                       stats_out=stats))
    assert not stats["fast_path"], stats  # the retry path ran (stats_out
    # reflects the FINAL retried frame, whose own overflow is 0)
    ref = np.asarray(cnr.render_staged(
        plane1_params, cam, base.replace(adaptive_rungs=False)))
    np.testing.assert_array_equal(img, ref)
    # The retry taught caps sized to the measured entries, not a blind
    # doubling of the hopeless 16-lane buckets.
    learned = renderer_lib.memo_lookup(plane1_params, tiny)
    assert learned.refine_caps and learned.refine_caps != tiny.refine_caps
    assert learned.refine_caps[0] >= 16 * 4  # re-fitted, not just doubled
    cnr.reset_schedule_memo()


def test_widen_doubles_caps():
    """_widen doubles explicit caps alongside halving divisors, clamped at
    the image size (a bucket spanning the image cannot overflow, so the
    retry loop terminates)."""
    from cudaneuralrender.render import renderer as renderer_lib

    cfg = cnr.RenderConfig(width=64, height=64,
                           refine_caps=(3000, 2000, 1000, 500))
    w = renderer_lib._widen(cfg)
    assert w.refine_caps == (4096, 4000, 2000, 1000)  # 3000*2 clamps at 4096
    assert all(d2 == max(d // 2, 1) for (d, _), (d2, _) in
               zip(cfg.refine_schedule, w.refine_schedule))


def test_tune_caps_ineligible_paths():
    """tune_caps returns None for non-mixed configs, disabled adaptivity,
    already-capped configs, and mismatched stats lengths."""
    from cudaneuralrender.render import renderer as renderer_lib

    cfg = cnr.RenderConfig(width=512, height=512)
    acts = [40000, 20000, 5000, 100]
    assert renderer_lib.tune_caps(cfg, acts) is not None
    assert renderer_lib.tune_caps(
        cfg.replace(adaptive_rungs=False), acts) is None
    assert renderer_lib.tune_caps(
        cfg.replace(march_precision="full"), acts) is None
    assert renderer_lib.tune_caps(
        cfg.replace(refine_caps=(8192, 8192, 8192, 8192)), acts) is None
    assert renderer_lib.tune_caps(cfg, acts[:2]) is None


def test_interactive_packed_frame_bytes(plane1_params):
    """The u32-packed interactive display path (quarter the device->host
    transfer) yields byte-identical frames to the f32 path."""
    from cudaneuralrender.utils import image_io

    cnr.reset_schedule_memo()
    cfg = cnr.RenderConfig(width=64, height=64, scene="neural_raw",
                           max_steps=300, march_impl="staged")
    r = cnr.Renderer(plane1_params, cfg)
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    packed_img = r.render_frame_interactive(cam)
    f32_img = image_io.to_uint8_image(np.asarray(r.render_interactive(cam)))
    np.testing.assert_array_equal(packed_img, f32_img)
    packed = np.asarray(r.render_interactive_packed(cam))
    assert packed.shape == (64, 64) and packed.dtype == np.uint32
    cnr.reset_schedule_memo()
