"""The port's CLIs on the CPU, tiny config.

`python -m hrfuser_tpu_torch.tools.test --synthetic` (through `main`)
writes the JAX CLI's JSON keys and refuses dataset mode with the slice it
waits for; `tools.serve` on a thread answers /healthz, /predict and
/predict_multi (uint16 sensor PNGs, dequantized on the device) with what
`inference_detector` gives, 404 for unknown paths and 400 for a JPEG.
"""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest

from hrfuser_tpu_torch import inference_detector, init_detector
from hrfuser_tpu_torch.tools import serve
from hrfuser_tpu_torch.tools import test as test_cli

NAME = 'tiny_fusion_test'


def test_synthetic_cli_writes_metrics(tmp_path, capsys):
    out = tmp_path / 'm.json'
    test_cli.main([NAME, '--synthetic', '--device', 'cpu', '--img-hw', '64',
                   '96', '--out', str(out)])
    metrics = json.loads(out.read_text())
    assert set(metrics) == {'synthetic_img_per_s', 'num_detections'}
    assert metrics['synthetic_img_per_s'] > 0
    assert 0 <= metrics['num_detections'] <= 2 * 20
    assert 'img/s' in capsys.readouterr().out


def test_dataset_mode_names_the_data_slice():
    with pytest.raises(SystemExit, match='data slice'):
        test_cli.main([NAME, '--device', 'cpu'])


@pytest.fixture(scope='module')
def server():
    det = init_detector(NAME, 'cpu', seed=0)
    # a 96x64 model grid keeps the CPU forwards small: the 60x90 requests
    # resize to 64x96
    det.data = dataclasses.replace(det.data, img_scale=(96, 64))
    srv = serve.make_server(det, '127.0.0.1', 0)
    assert srv.warm_up_s > 0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield det, f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


# a local server: never through a proxy the environment may name
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _call(url, data=None):
    try:
        with _OPENER.open(url, data=data, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(img):
    ok, buf = cv2.imencode('.png', img)
    assert ok
    return buf.tobytes()


def _request():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (60, 90, 3)).astype(np.uint8)
    mods = [rng.integers(19900, 21000, (60, 90, 3)).astype(np.uint16)
            for _ in range(2)]
    return img, mods


def test_healthz_and_unknown_paths(server):
    _, url = server
    assert _call(url + '/healthz') == (200, {'status': 'ok'})
    assert _call(url + '/nope')[0] == 404
    assert _call(url + '/nope', b'{}')[0] == 404


def test_predict_multi_answers_as_inference_detector(server):
    det, url = server
    img, mods = _request()
    body = json.dumps({'img': base64.b64encode(_png(img)).decode(),
                       'mods': [base64.b64encode(_png(m)).decode()
                                for m in mods]}).encode()
    code, reply = _call(url + '/predict_multi', body)
    assert code == 200
    want = inference_detector(det, img, mods)
    assert reply['labels'] == want['labels'].tolist()
    np.testing.assert_allclose(reply['boxes'], want['boxes'].reshape(-1, 4),
                               atol=0.01)
    np.testing.assert_allclose(reply['scores'], want['scores'], atol=1e-4)
    assert reply['class_names'] == [det.data.classes[i]
                                    for i in reply['labels']]
    assert reply['latency_ms'] > 0


def test_predict_camera_only(server):
    det, url = server
    img, _ = _request()
    code, reply = _call(url + '/predict', _png(img))
    assert code == 200
    assert reply['labels'] == inference_detector(det, img)['labels'].tolist()


def test_jpeg_gets_a_400(server):
    _, url = server
    ok, jpg = cv2.imencode('.jpg', _request()[0])
    code, reply = _call(url + '/predict', jpg.tobytes())
    assert code == 400 and 'JPEG' in reply['error']
    code, _ = _call(url + '/predict_multi', b'not json')
    assert code == 400
