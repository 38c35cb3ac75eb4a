"""Render configuration.

Replacement for the reference's scattered configuration state: compile-time
march constants (reference: src/volumeRender_kernel.cu:57-61), CUDA
``__constant__`` memory settings (src/volumeRender_kernel.cu:31-35,
copyStaticSettings src/volumeRender_kernel.cu:702-706) and the hand-rolled CLI
defaults (src/main.cpp:557-631).

The config is a frozen, hashable dataclass passed as a jit-static argument,
so XLA specializes the compiled program on it (resolution, step budget,
scene, shading mode are all static shapes / static control flow).

Defaults below that were tuned for speed were tuned on the previous
accelerator; PERF.md lists which of them the H100 has re-measured.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable -> usable as jax.jit static arg).

    Defaults mirror the reference renderer's operating point:
      * 512x512 default resolution      (src/main.cpp:576-586)
      * MAX_STEPS=6000                  (src/volumeRender_kernel.cu:61)
      * MARCHING_EPSILON=1e-6           (src/volumeRender_kernel.cu:60)
      * NORMAL_EPSILON=1e-5             (src/volumeRender_kernel.cu:59)
      * bounding sphere r=1.2 at origin (src/volumeRender_kernel.cu:325-328)
      * focal length -2 ray z           (src/volumeRender_kernel.cu:321)
    """

    width: int = 512
    height: int = 512

    # Sphere-trace budget / tolerances.
    max_steps: int = 6000
    march_eps: float = 1e-6
    normal_eps: float = 1e-5

    # Scene bounding sphere (empty-space culling before marching).
    bound_center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    bound_radius: float = 1.2

    # Camera projection: rays leave the eye through (u, v, -focal).
    focal: float = 2.0

    # Scene composition applied around the raw neural SDF logit.
    # "neural_raw" reproduces the reference's checked-in behavior of using the
    # network's pre-tanh output directly as a distance
    # (quirk documented at src/volumeRender_kernel.cu:217-230 via simpleInfer.cpp:109).
    scene: str = "neural_raw"

    # "facing" (c_coloringType==0) or "matcap" (==1), src/volumeRender_kernel.cu:446-453.
    shading: str = "facing"

    # Surface-normal estimator: "autodiff" (jax.grad of the SDF — exact, the
    # default) or "tetrahedron" (4-tap finite difference, parity
    # with src/volumeRender_kernel.cu:362-377).
    normal_mode: str = "autodiff"

    # 3 = (x, y, z); 4 = (x, y, z, frame) animation mode
    # (c_numInputs, src/volumeRender_kernel.cu:34, createBatch :533-544).
    num_inputs: int = 3

    # March loop implementation:
    #   "while"      - lax.while_loop, exits when every ray resolves
    #   "fori"       - fixed-length unrolled-scan march (reverse-differentiable)
    #   "staged"     - multi-stage compaction: re-packs active rays into a
    #                  smaller dense batch between stages (the fast path for
    #                  deep marches — the straggler tail costs ~0 work)
    march_impl: str = "while"

    # Staged-compaction schedules (march_impl="staged"). Each phase starts
    # with `stage_steps` dense steps, then per (div, steps) rung packs the
    # surviving active rays into a static N/div batch, marches `steps` more
    # (0 = until the phase's while-loop runs dry), and scatters back.
    # Everything runs inside ONE compiled program — zero mid-march host
    # syncs; leftovers (bucket overflow / remaining budget) fall to a
    # host-driven continuation loop, so schedules are performance hints,
    # never correctness hazards.
    #
    # The coarse phase (eps=0.05) runs dry in a few tens of steps; the
    # deep-step tail exists only at fine precision, where the near-surface
    # refine set is a fraction of the image and its stragglers can need
    # 1000+ steps, hence the refine ladder.
    stage_steps: int = 8
    coarse_schedule: Tuple[Tuple[int, int], ...] = ((4, 0),)
    # Rung sizes follow the active-ray decay of the near set (shrink the
    # bucket right as the bulk converges instead of holding N/4).
    refine_schedule: Tuple[Tuple[int, int], ...] = ((4, 16), (8, 24), (32, 64), (256, 0))
    # Explicit per-rung lane caps for the HIGHEST refine ladder, overriding
    # each rung's default n//div bucket. () = use the divisors. Set by the
    # stats-driven adaptive tuner (renderer.tune_caps): the default divisors
    # are image-fraction guesses, so on most (geometry, camera) pairs the
    # bounded rungs run partly empty — the recorded per-rung entry-active
    # counts (stats[4:]) size the buckets to the measured near-set decay
    # instead. Values are lane counts at THIS config's num_rays; sharded
    # callers scale them to their bundle size (renderer._cap_for). Purely a
    # performance hint: a cap the frame outgrows raises the same
    # refine_overflow retry the divisor schedule uses (now also for
    # stranded actives in LATER rungs), which doubles the caps and
    # re-teaches the memo.
    refine_caps: Tuple[int, ...] = ()
    # Allow render paths to LEARN refine_caps from the per-rung stats of
    # successful frames (through the adaptive-schedule memo). Disable for
    # strictly reproducible dispatch behavior across calls.
    adaptive_rungs: bool = True
    # march_precision="full" phase-A schedule (HIGHEST everywhere).
    fine_schedule: Tuple[Tuple[int, int], ...] = ((4, 48), (32, 192), (256, 0))
    compact_min: int = 2048

    # Shading bucket: hit pixels are packed into a N/shade_div batch before
    # normal estimation + coloring (foreground is typically 3-10% of the
    # image; dense shading would pay 4-5 whole-image MLP evals). Overflow
    # falls back to dense shading via a host check.
    shade_div: int = 8

    # Carry the shaded colors through the image-order restore sort as ONE
    # u32 payload (8-bit channels packed a<<24|b<<16|g<<8|r — the
    # reference's own display format, rgbaFloatToInt
    # volumeRender_kernel.cu:266-274) instead of four f32 channels. The
    # restore sort is the shading stage's dominant cost
    # (benchmarks/exp_shade3.py); quantization is exactly the u8 conversion
    # every saved/displayed frame undergoes anyway (image_io.to_uint8_image
    # recovers identical bytes). False keeps f32 colors end-to-end for
    # tolerance studies against the dense path.
    rgba_packed: bool = True

    # Matmul precision for shading normals: "highest" | "high" | "default".
    shade_precision: str = "highest"

    # Matmul precision of the SHADING chain inside the differentiated
    # training loss (diff/losses._pixel_loss_compact). The grad program is
    # chain-bound — its normals carry second-order chain terms — so it
    # runs at HIGH (TF32 on the GPU); the implicit-t reattachment always
    # stays at HIGHEST. "highest" gives exact f32 gradients.
    grad_shade_precision: str = "high"

    # Mixed-precision march (staged path): "mixed" runs a precision ladder —
    # each phase marches at a cheaper matmul precision down to an epsilon
    # that dominates that precision's SDF error (PERF.md has the table
    # measured on the H100: TF32 ~3e-3, IEEE f32 ~8e-7 on csg_demo):
    #   DEFAULT (TF32 on the GPU)     -> eps coarse_eps (0.05)
    #   HIGH    (TF32 on the GPU)     -> eps mid_eps (optional phase)
    #   HIGHEST (IEEE f32)            -> eps march_eps
    # Between phases the near-surface set (converged-or-active) re-packs
    # into the next phase's refine_schedule ladder. "full" = HIGHEST
    # everywhere (exact reference semantics). The mixed image differs from
    # full only by silhouette-level noise in budget-miss decisions.
    # mid_eps > march_eps enables the optional HIGH middle phase; 0.0 (the
    # default) goes straight DEFAULT -> HIGHEST.
    march_precision: str = "mixed"
    # Matmul precision of the coarse phase: "default" or "high" (both TF32
    # on the GPU).
    coarse_precision: str = "default"
    coarse_eps: float = 0.05
    mid_eps: float = 0.0
    # Ladder schedule for the optional HIGH middle phase (mid_eps > 0);
    # empty = reuse refine_schedule. With a mid phase the HIGHEST phase's
    # rays start ~mid_eps from the surface, so refine_schedule should then
    # be retuned shorter (the decay curves differ per phase).
    mid_schedule: Tuple[Tuple[int, int], ...] = ()

    # Over-relaxed sphere tracing (Keinert et al. 2014): active rays step
    # omega*d and backtrack to the previous plain-step position when
    # consecutive safety spheres stop overlapping (ops/march.py,
    # march_stage_relaxed — provably miss-free under the same 1-Lipschitz
    # assumption plain sphere tracing makes). Applied on the staged mixed
    # path only; "full" keeps exact reference stepping. 0/1 disables. With
    # relax_newton off it is not applied in the refine phase's first rung
    # (see renderer._refine_phase), whose rays sit head-on near the surface
    # where a fixed omega overshoots and backtracks every other step.
    relax_omega: float = 1.6

    # Over-relaxation for the refine-ladder rungs after rung 0. Too small an
    # omega moves grazing stragglers less per step, so more of them overflow
    # the fixed-bound later rungs into the host slow path.
    relax_omega_refine: float = 1.6

    # Newton/secant-adaptive relaxation ("accelerated sphere tracing"): the
    # per-ray step multiplier becomes clip(1/g, 1, relax_omega_max) where g
    # is the secant slope of the SDF along the ray. Off by default: on
    # curved silhouettes the secant slope collapses near the closest
    # approach, so 1/g leaps exactly where care is needed (backtrack thrash
    # on the analytic sphere's grazing fan), and on a non-Lipschitz neural
    # SDF the amplified oversteps can step through silhouette pixels.
    relax_newton: bool = False
    relax_omega_max: float = 8.0

    # Difficulty-ordered refine packing: key the refine phase's entry sort
    # by each ray's coarse-phase resolve step so stragglers cluster into few
    # kernel blocks and easy blocks exit bounded rungs early.
    ordered_packing: bool = True

    # Run the refine ladder's rungs (the near-surface bucket x HIGHEST
    # steps, then the straggler buckets) in the march kernel
    # (pallas/march_kernel.py) with weights, activations and ray state on
    # chip; False runs them as XLA while loops. Kernel scenes and nets up
    # to march_kernel.MAX_WIDTH only; a no-op otherwise.
    refine_pallas: bool = True

    # Lane order for the coarse kernel pass: group rays into (rows, cols)
    # image blocks so each kernel block covers a compact 2D region. Free to
    # apply: directions/budget are recomputed from the carried pixel index
    # and the restore sort keys on it, and per-ray results are
    # bit-identical (the kernel runs to dry per lane). () disables (image
    # order). Skipped when prepass/grid phases produced an image-order init
    # state.
    coarse_block: Tuple[int, int] = (128, 128)

    # Run the whole coarse phase (mixed mode) as one run-to-dry march
    # kernel pass over the full image at DEFAULT precision: per-block early
    # exit IS the compaction (sky blocks die in a few steps), so phase A
    # needs no dense prefix, no sort, no bucket rung. False runs the XLA
    # coarse phase (dense prefix + sorted bucket rungs).
    coarse_pallas: bool = True

    # many_cylinder_cut in-kernel grid window (pallas/scenes.py): 5 = exact
    # for scene distance > -0.2, 3 = exact for > -0.1 (same interior-only
    # error class — the march stops at the surface) at ~2.8x less compose
    # work per lane-step. The dense XLA path always runs the complete
    # 300-cylinder chain.
    cyl_window: int = 3

    # Grid window for the COARSE kernel phase only. Dropping smooth-subtract
    # cut terms can only UNDERESTIMATE the scene distance (each term enters
    # as ~max(d, -cyl)), so a smaller coarse window is conservative: steps
    # shrink, never overshoot; rays that falsely converge on an omitted
    # drill wall enter the refine phase, whose accurate window marches them
    # through. 1 = nearest cylinder only.
    cyl_window_coarse: int = 1

    # Baked-distance-grid empty-space skipping (ops/grid.py): an 8-tap
    # trilinear gather per step. 0 = off (the default); not yet measured on
    # the GPU (ROADMAP speed item 4).
    grid_res: int = 0

    # Cone-traced low-res depth prepass (ops/prepass.py): march a
    # (H/f × W/f) grid with cone-safe steps, min-pool the safe depths, and
    # start every full-res ray there (sky neighborhoods die without
    # full-res marching). Dense ops only. 0/1 disables; mixed path only —
    # "full" keeps exact reference stepping. Off by default: the bounding
    # sphere already culls most sky on the shipped geometries; useful for
    # sky-heavy scenes or cameras inside the bounding volume.
    prepass_factor: int = 0

    # Temporal warm start (render_sequence(..., warm_start=True)): frame N+1
    # starts each ray at max(tnear, t_N - warm_margin) where frame N hit,
    # instead of at the bounding sphere. For smooth camera paths (the
    # turntable's 1 deg/frame, interactive orbiting) the surface depth along
    # a pixel's ray moves by <= |p|*dtheta/cos(incidence) ~ 0.02 between
    # frames, so the warm point is still in free space and the coarse march
    # re-converges in a handful of steps. Rays whose warm point lands inside
    # the surface (SDF < 0 at init — a closer surface swung in front) are
    # detected by the first coarse evaluation and reset to a cold start;
    # stepping PAST a newly interposed surface that is > warm_margin in
    # front of the old one remains possible at grazing incidence, which is
    # why warm starts are opt-in and benchmarks render cold. Margin 0.08 is
    # ~4x the 1 deg/frame depth-motion bound.
    warm_margin: float = 0.08

    # Compute dtype for MLP matmuls. Positions/distances always stay float32
    # (march_eps=1e-6 is far below bf16 resolution).
    mlp_dtype: str = "float32"

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def num_rays(self) -> int:
        return self.height * self.width

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "RenderConfig":
        if self.scene not in SCENE_NAMES:
            raise ValueError(f"unknown scene {self.scene!r}; choose from {sorted(SCENE_NAMES)}")
        if self.shading not in ("facing", "matcap"):
            raise ValueError(f"unknown shading {self.shading!r}")
        if self.normal_mode not in ("autodiff", "tetrahedron"):
            raise ValueError(f"unknown normal_mode {self.normal_mode!r}")
        if self.march_impl not in ("while", "fori", "staged"):
            raise ValueError(f"unknown march_impl {self.march_impl!r}")
        if self.num_inputs not in (3, 4):
            raise ValueError("num_inputs must be 3 or 4")
        if self.refine_caps and len(self.refine_caps) != len(self.refine_schedule):
            raise ValueError(
                "refine_caps must be empty or match refine_schedule length")
        if any(c <= 0 for c in self.refine_caps):
            raise ValueError("refine_caps entries must be positive")
        if self.coarse_precision not in ("default", "high"):
            raise ValueError(f"unknown coarse_precision {self.coarse_precision!r}")
        if self.cyl_window not in (3, 5):
            raise ValueError("cyl_window must be 3 or 5")
        if self.cyl_window_coarse not in (1, 3, 5):
            raise ValueError("cyl_window_coarse must be 1, 3 or 5")
        if self.shade_precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown shade_precision {self.shade_precision!r}")
        if self.grad_shade_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"unknown grad_shade_precision {self.grad_shade_precision!r}")
        return self


# Scene registry names (implementations live in ops/sdf.py).
SCENE_NAMES = frozenset(
    {
        "neural_raw",        # raw network logit as distance (reference checked-in behavior)
        "neural_tanh",       # tanh(logit) as distance (the reference's intended plain path)
        "many_sphere",       # smooth-union of 9 animated spheres with the neural SDF
        "many_sphere_cut",   # smooth-subtraction variant
        "many_cylinder_cut", # 300-cylinder drill pattern
        "displacement",      # sine displacement of tanh(logit)
        "sphere",            # analytic sphere only (no network) — for tests
    }
)
