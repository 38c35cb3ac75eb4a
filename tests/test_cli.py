"""CLI surface tests (cli.py) — the reference binary's flag contract
(src/main.cpp:536-631) driven in-process on tiny frames."""
import json
import os

import numpy as np
import pytest

from cudaneuralrender import cli
from cudaneuralrender.utils import image_io

H5 = "/root/reference/neuralGeometries/plane_1.h5"


@pytest.fixture(autouse=True)
def _require_reference():
    if not os.path.exists(H5):
        pytest.skip("reference assets unavailable")


def test_single_frame(tmp_path, capsys):
    out = str(tmp_path / "f.png")
    rc = cli.main(["-i", H5, "--single", "-W", "24", "-H", "24",
                   "--steps", "64", "-o", out])
    assert rc == 0
    cap = capsys.readouterr().out
    assert "volumeRender, Throughput =" in cap  # reference's benchmark line
    img = image_io.load_png(out)
    assert img.shape == (24, 24, 4)


def test_single_frame_ppm_and_flip(tmp_path):
    out = str(tmp_path / "f.ppm")
    rc = cli.main(["-i", H5, "--single", "-W", "16", "-H", "16",
                   "--steps", "32", "--parity-flip", "-o", out])
    assert rc == 0
    assert image_io.load_ppm(out).shape == (16, 16, 3)


def test_matcap_flag(tmp_path, matcap_path):
    out = str(tmp_path / "m.png")
    rc = cli.main(["-i", H5, "--single", "-W", "16", "-H", "16",
                   "--steps", "32", "-M", matcap_path, "-ry", "40", "-o", out])
    assert rc == 0
    assert os.path.exists(out)


def test_stats_json_line(tmp_path, capsys):
    out = str(tmp_path / "s.png")
    rc = cli.main(["-i", H5, "--single", "-W", "16", "-H", "16",
                   "--steps", "32", "--stats", "-o", out])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    stats = json.loads(lines[0])
    assert {"ms", "rays", "steps", "hits"} <= set(stats)
    assert stats["rays"] == 256


def test_fault_inject_flag(tmp_path, capsys):
    out = str(tmp_path / "fi.png")
    rc = cli.main(["-i", H5, "--single", "-W", "16", "-H", "16",
                   "--steps", "32", "--fault-inject", "1", "-o", out])
    assert rc == 0
    assert "1 injected failures recovered" in capsys.readouterr().out


def test_save_ckpt_roundtrip(tmp_path):
    ck = str(tmp_path / "w.npz")
    rc = cli.main(["-i", H5, "--single", "-W", "8", "-H", "8",
                   "--steps", "16", "--save-ckpt", ck,
                   "-o", str(tmp_path / "x.png")])
    assert rc == 0
    import cudaneuralrender as cnr

    a = cnr.load(H5)
    b = cnr.load(ck)
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(la.w), np.asarray(lb.w))
