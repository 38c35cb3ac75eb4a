"""Browser-viewer server (render/viewer.py) — the GLUT-window equivalent
(reference src/main.cpp:130-205,283-353): frame endpoint, pan/zoom params,
save endpoint, HTML page with the control bindings."""
import io
import threading
import urllib.request

import numpy as np
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.render import viewer


@pytest.fixture(scope="module")
def server(plane1_params, tmp_path_factory):
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=200)
    r = cnr.Renderer(plane1_params, cfg)
    srv = viewer.make_server(r, cnr.Camera(), port=0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def test_page_served(server):
    page = _get(server + "/").decode()
    assert "canvas" in page and "shift-drag=pan" in page


def test_frame_png_and_pan_changes_image(server):
    from PIL import Image

    base = _get(server + "/frame?rx=0&ry=0&zoom=2")
    panned = _get(server + "/frame?rx=0&ry=0&zoom=2&tx=0.4&ty=0.0")
    a = np.asarray(Image.open(io.BytesIO(base)))
    b = np.asarray(Image.open(io.BytesIO(panned)))
    assert a.shape == (32, 32, 4)
    assert (a[..., :3].sum(-1) > 0).any()
    assert not np.array_equal(a, b), "pan must move the image"
    # lateral pan: same hit count, shifted silhouette (object fully in view)
    assert abs(int((a[..., 3] > 0).sum()) - int((b[..., 3] > 0).sum())) < 60


def test_camera_endpoint_dump(server):
    """The `q` camera dump (reference src/main.cpp:295) as /camera JSON."""
    import json

    body = _get(server + "/camera?rx=15.5&ry=30.25&zoom=2.5&tx=0.1&ty=-0.2&frame=7")
    cam = json.loads(body)
    assert cam["rotation_x"] == pytest.approx(15.5)
    assert cam["rotation_y"] == pytest.approx(30.25)
    assert cam["zoom"] == pytest.approx(2.5)
    assert cam["translation_x"] == pytest.approx(0.1)
    assert cam["translation_y"] == pytest.approx(-0.2)
    assert cam["frame"] == pytest.approx(7.0)


def test_page_has_playback_and_fps(server):
    """Continuous playback + rolling FPS (reference computeFPS
    src/main.cpp:111-128 and the GLUT idle animation)."""
    page = _get(server + "/").decode()
    assert "p=play" in page and "q=camera" in page
    assert "playing=!playing" in page.replace(" ", "")
    assert "fps" in page
    assert "/camera?" in page


def test_render_interactive_matches_sync(plane1_params):
    """The optimistic interactive path must produce the same pixels as the
    synchronous render on fast-path frames, and its deferred check must
    teach the schedule memo after an overflow frame."""
    import cudaneuralrender as cnr
    from cudaneuralrender.render import renderer as renderer_lib

    cnr.reset_schedule_memo()
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=300, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    r = cnr.Renderer(plane1_params, cfg)
    cams = [cnr.Camera(rotation_y=20.0 + i) for i in range(3)]
    for cam in cams:
        a = np.asarray(r.render_interactive(cam))
        b = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
        np.testing.assert_array_equal(a, b)

    # overflow config: frame N shows the (possibly degraded) optimistic
    # image; by frame N+2 the deferred check has taught the widened
    # schedule and the memo redirects
    tiny = cfg.replace(refine_schedule=((1024, 4), (1024, 0)), compact_min=8)
    r2 = cnr.Renderer(plane1_params, tiny)
    r2.render_interactive(cams[0])
    r2.render_interactive(cams[1])  # validates frame 0, teaches memo
    assert renderer_lib.memo_lookup(plane1_params, tiny) != tiny
    cnr.reset_schedule_memo()
