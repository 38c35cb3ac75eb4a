"""Multi-host integration: 2 real processes, localhost coordinator.

The standard JAX stand-in for multi-host hardware (SURVEY.md §4): each
spawned process gets 4 virtual CPU devices, joins a jax.distributed world,
and the 8-device global mesh spans both. Asserts the assembled per-host
tiles equal the single-process render for both multi-host paths
(global-SPMD and independent bands), that elastic band failover covers a
failed host, and that the cross-host training step reproduces the
single-process loss. Replaces the reference's single-device world
(src/main.cpp:500).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.parallel import multihost

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_run(tmp_path_factory, plane1_path):
    """Spawn the 2-process world once; every test asserts on its outputs."""
    outdir = str(tmp_path_factory.mktemp("mh"))
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker pins its own 4-device flag
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, f"localhost:{port}", "2", str(pid),
             outdir, plane1_path],
            cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out)
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-4000:]}"
    return outdir


@pytest.fixture(scope="module")
def reference_image(plane1_params):
    """Single-process ground truth — the same math the workers sharded."""
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=10.0)
    return np.asarray(cnr.render_image(plane1_params, cam, cfg))


def test_gspmd_tiles_assemble_to_single_process_image(multihost_run, reference_image):
    img = multihost.assemble_tiles(multihost_run, "gspmd")
    assert img.shape == reference_image.shape
    np.testing.assert_allclose(img, reference_image, atol=1e-5)


def test_gather_image_replicates_everywhere(multihost_run, reference_image):
    g0 = np.load(os.path.join(multihost_run, "gather_p0.npy"))
    g1 = np.load(os.path.join(multihost_run, "gather_p1.npy"))
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_allclose(g0, reference_image, atol=1e-5)


def test_band_tiles_assemble_to_single_process_image(multihost_run, reference_image):
    img = multihost.assemble_tiles(multihost_run, "bands")
    np.testing.assert_allclose(img, reference_image, atol=1e-5)


def test_failover_bands_cover_failed_host(multihost_run, reference_image):
    """Host 1 declared failed: host 0 adopted every band, and the image is
    still complete and correct."""
    img = multihost.assemble_tiles(multihost_run, "failover")
    np.testing.assert_allclose(img, reference_image, atol=1e-5)


def test_cross_host_train_step_matches_single_process(multihost_run, plane1_params):
    from cudaneuralrender.diff import train as train_lib

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=10.0)
    target = np.zeros((32, 32, 4), np.float32)
    state = train_lib.init_train_state(plane1_params, lr=1e-3)
    ref_state, ref_loss = train_lib.pixel_train_step(state, cam, target, cfg, lr=1e-3)

    l0 = float(np.load(os.path.join(multihost_run, "loss_p0.npy")))
    l1 = float(np.load(os.path.join(multihost_run, "loss_p1.npy")))
    assert l0 == l1
    np.testing.assert_allclose(l0, float(ref_loss), rtol=1e-5)
    w0 = np.load(os.path.join(multihost_run, "trained_w0.npy"))
    np.testing.assert_allclose(w0, np.asarray(ref_state.params[0].w), atol=1e-6)


def test_band_owner_striping_and_failover():
    assert multihost.band_owners(4, 2) == [0, 1, 0, 1]
    assert multihost.band_owners(4, 2, failed_hosts=[1]) == [0, 0, 0, 0]
    assert multihost.band_owners(6, 3, failed_hosts=[2]) == [0, 1, 0, 0, 1, 1]
    with pytest.raises(ValueError):
        multihost.band_owners(2, 1, failed_hosts=[0])


def test_gspmd_staged_tiles_match_single_process(multihost_run, plane1_params):
    """Round-4: the staged fast path under the CROSS-PROCESS mesh — host
    tiles must assemble to the single-process staged render exactly."""
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=300, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=10.0)
    want = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    img = multihost.assemble_tiles(multihost_run, "gspmd_staged")
    np.testing.assert_array_equal(img, want)


def test_memo_broadcast_reaches_every_process(multihost_run):
    """An adaptive-schedule entry known only to rank 0 must be broadcast so
    the whole world dispatches the taught schedule with zero overflow
    retries (round-4 VERDICT item 6; the workers assert fast_path and
    refine_overflow==0 in-process and write these flags)."""
    for pid in (0, 1):
        flag = np.load(os.path.join(multihost_run, f"memo_fast_p{pid}.npy"))
        assert flag[0] == 1
