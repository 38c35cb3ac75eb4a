"""Worker process for tests/test_multihost.py — NOT a test module.

Joins a 2-process JAX distributed world on CPU (4 virtual devices per
process → one 8-device global mesh), renders through both multi-host paths,
runs one cross-host train step, and writes tiles/results for the parent
test to assert against the single-process ground truth.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)


def main() -> int:
    coordinator, nprocs, pid, outdir, model = sys.argv[1:6]
    nprocs, pid = int(nprocs), int(pid)

    from cudaneuralrender.parallel import multihost

    multihost.initialize(coordinator, nprocs, pid)
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()

    import numpy as np

    import cudaneuralrender as cnr
    from cudaneuralrender.diff import train as train_lib
    from cudaneuralrender.parallel.sharding import pixel_train_step_sharded

    params = cnr.load(model)
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=10.0)
    mesh = multihost.global_mesh()
    assert mesh.devices.size == 8, mesh.devices.size

    # 1. Global-SPMD render: one program over the cross-process mesh;
    #    each host writes only its own row-band tiles.
    img = multihost.render_global(params, cam, cfg, mesh)
    multihost.write_local_tiles(img, outdir, "gspmd")

    # 2. gather_image replicates the full image to every host — both hosts
    #    must see identical pixels (save per-host copies for the parent).
    full = multihost.gather_image(img)
    np.save(os.path.join(outdir, f"gather_p{pid}.npy"), full)

    # 3. Independent-band render: zero cross-host comms, striped ownership.
    bands = multihost.render_bands(params, cam, cfg, n_bands=4)
    multihost.write_band_tiles(bands, outdir, "bands")

    # 4. Elastic recovery: host 1 is declared failed; host 0 adopts its
    #    bands (host 1 writes nothing).
    bands_f = multihost.render_bands(params, cam, cfg, n_bands=4, failed_hosts=[1])
    multihost.write_band_tiles(bands_f, outdir, "failover")

    # 4b. STAGED fast path across processes (round-4): the whole staged
    #     pipeline runs per shard of the cross-process mesh; every process
    #     fetches the same replicated stats vector, so retry decisions stay
    #     in lockstep. Each host writes its row tiles; the parent asserts
    #     assembly == single-process staged render.
    s_cfg = cfg.replace(march_impl="staged", coarse_pallas=False,
                        refine_pallas=False)
    img_s = multihost.render_global(params, cam, s_cfg, mesh)
    multihost.write_local_tiles(img_s, outdir, "gspmd_staged")

    # 4c. Memo broadcast (round-4 VERDICT item 6): an adaptive-schedule
    #     entry known ONLY to rank 0 (e.g. from its persistent store) must
    #     reach every process through _memo_lookup_synced, so the whole
    #     world dispatches the taught schedule in lockstep — zero overflow
    #     retries on a config whose BASE schedule is overflow-prone.
    from cudaneuralrender.render import renderer as renderer_lib
    from cudaneuralrender.utils import memo as memo_store

    prone = cfg.replace(
        march_impl="staged", coarse_pallas=False, refine_pallas=False,
        compact_min=8, refine_schedule=((1024, 4), (1024, 0)),
        adaptive_rungs=False,
    )
    memo_store.tag_geometry(params, "plane_1.h5")
    if pid == 0:
        taught = prone.replace(refine_schedule=((1, 4), (1, 0)))
        renderer_lib.memo_teach(params, prone, taught)
    from cudaneuralrender.parallel.sharding import (
        render_image_sharded_staged,
    )

    st_memo: dict = {}
    render_image_sharded_staged(params, cam, prone, mesh, stats_out=st_memo)
    assert st_memo["fast_path"], (pid, st_memo)
    assert st_memo["refine_overflow"] == 0, (pid, st_memo)
    np.save(os.path.join(outdir, f"memo_fast_p{pid}.npy"),
            np.asarray([1 if st_memo["fast_path"] else 0]))

    # 5. One cross-host training step: pixel targets tile-sharded over the
    #    global mesh, weight grads psummed across hosts over the coordinated
    #    backend. Loss must equal the single-process step.
    target = np.zeros((32, 32, 4), np.float32)
    state = train_lib.init_train_state(params, lr=1e-3)
    new_state, loss = pixel_train_step_sharded(state, cam, target, cfg, mesh)
    np.save(os.path.join(outdir, f"loss_p{pid}.npy"), np.asarray(loss))
    if pid == 0:
        w0 = multihost.gather_image  # noqa: F841 — keep namespace tidy
        first_w = np.asarray(new_state.params[0].w)
        np.save(os.path.join(outdir, "trained_w0.npy"), first_w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
