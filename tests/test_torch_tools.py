"""The port's CLIs on the CPU, tiny config.

`python -m hrfuser_tpu_torch.tools.test --synthetic` (through `main`)
writes the JAX CLI's JSON keys, on a fusion and a camera-only config, and
its dataset mode names the split it reads; `tools.serve` on a
thread answers /healthz, /predict and /predict_multi (uint16 sensor PNGs,
dequantized on the device; none for a camera-only config; a grey PNG as
one channel; 8-bit JPEGs, decoded on the detector's device) with what
`inference_detector` gives, a JPEG camera as the
PNG of its decoded pixels (baseline, progressive and arithmetic-coded
JPEGs alike), a lossless camera and lossless grey sensors as
`inference_detector` answers `cv2`'s decodes of them, 404 for unknown
paths and 400 for a JPEG mode the decoder refuses (12-bit, a lossless
grey camera) or a body that is not JSON; a BMP or PPM camera as the PNG
of its pixels, and a 400 naming what it met for a cut BMP or bytes no
decoder reads; a WebP camera (lossless, lossy, with alpha, animated) as
the PNG of `cv2`'s decode of it, a 400 naming WebP for a cut one;
`--input-hw` sets the grid of the warm-up call.
"""

import base64
import dataclasses
import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from hrfuser_tpu_torch import (get_experiment, inference_detector,
                               init_detector)
from hrfuser_tpu_torch.data.pipelines import loading
from hrfuser_tpu_torch.data.png import imdecode
from hrfuser_tpu_torch.tools import serve
from hrfuser_tpu_torch.tools import test as test_cli

sys.path.insert(0, str(Path(__file__).resolve().parent / 'oracles'))
import jpeg_encoder as enc  # noqa: E402
import raster_files as rf  # noqa: E402
import tiff_files as tf  # noqa: E402
import webp_files as wf  # noqa: E402

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


def test_synthetic_cli_on_a_camera_only_config(tmp_path, capsys):
    """`tiny_camera_test`: no sensor streams are made or fed."""
    out = tmp_path / 'm.json'
    test_cli.main(['tiny_camera_test', '--synthetic', '--device', 'cpu',
                   '--img-hw', '64', '96', '--out', str(out)])
    metrics = json.loads(out.read_text())
    assert 0 <= metrics['num_detections'] <= 2 * 20
    assert 'img/s' in capsys.readouterr().out


def test_dataset_mode_names_the_data_slice(tmp_path):
    """Dataset mode reads the split the converters write under
    `--data-root`; a root without it names the file it wants."""
    with pytest.raises(FileNotFoundError,
                       match='nuscenes_infos_val_mono3d.coco.json'):
        test_cli.main([NAME, '--device', 'cpu', '--data-root',
                       str(tmp_path)])


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


def test_bmp_and_ppm_cameras_answer_as_the_png(server):
    """The camera decoder is chosen by the first bytes: the same pixels
    as a 24-bit BMP and as a P6 PPM are answered as their PNG is; a cut
    BMP and bytes no decoder reads get a 400 that names them."""
    _, url = server
    img, _ = _request()
    code, want = _call(url + '/predict', _png(img))
    assert code == 200
    want.pop('latency_ms')
    for data in (rf.bmp(img), rf.pnm(img)):
        code, reply = _call(url + '/predict', data)
        assert code == 200
        reply.pop('latency_ms')
        assert reply == want
    code, reply = _call(url + '/predict', rf.bmp(img)[:200])
    assert code == 400 and reply['error'].startswith('BMP')
    code, reply = _call(url + '/predict', b'GIF89a' + bytes(64))
    assert code == 400 and 'unknown image signature' in reply['error']


def test_a_tiff_camera_answers_as_the_png(server):
    """The same pixels as an LZW TIFF, a tiled Deflate BigTIFF and a
    16-bit TIFF are answered as their PNG is; a cut TIFF gets a 400 that
    names it."""
    _, url = server
    img, _ = _request()
    code, want = _call(url + '/predict', _png(img))
    assert code == 200
    want.pop('latency_ms')
    rgb = np.ascontiguousarray(img[..., ::-1])
    for data in (tf.tiff(rgb, compression=5, predictor=2, rows=16),
                 tf.tiff(rgb, compression=8, tile=(64, 64), big=True),
                 tf.tiff(rgb.astype(np.uint16) * 257, compression=5)):
        code, reply = _call(url + '/predict', data)
        assert code == 200
        reply.pop('latency_ms')
        assert reply == want
    code, reply = _call(url + '/predict', tf.tiff(rgb)[:300])
    assert code == 400 and reply['error'].startswith('TIFF')


def test_a_webp_camera_answers_as_the_png(server):
    """The same pixels as lossless WebP (the oracle's and `cv2`'s) are
    answered as their PNG is; lossy WebP, with alpha and as an
    animation's first frame, as the PNG of `cv2`'s decode; through
    /predict_multi too; a cut WebP gets a 400 that names it."""
    _, url = server
    img, mods = _request()
    code, want = _call(url + '/predict', _png(img))
    assert code == 200
    want.pop('latency_ms')
    lossless = (wf.lossless(img), cv2.imencode(
        '.webp', img, [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes())
    for data in lossless:
        code, reply = _call(url + '/predict', data)
        assert code == 200
        reply.pop('latency_ms')
        assert reply == want
    h, w = img.shape[:2]
    vp8 = wf.lossy(img, q=40)
    chunks = wf.chunk(b'VP8 ', vp8)
    lossy = (wf.container(vp8, False),
             wf.with_alpha(vp8, w, h, wf.alph(img[..., 1], 1, 3)),
             wf.animation((w + 4, h + 6), [(chunks, w, h, 4, 2, 0)]))
    sensors = [base64.b64encode(_png(m)).decode() for m in mods]
    for data in lossy:
        pixels = cv2.imdecode(np.frombuffer(data, np.uint8),
                              cv2.IMREAD_COLOR)
        code, want = _call(url + '/predict', _png(pixels))
        assert code == 200
        want.pop('latency_ms')
        code, reply = _call(url + '/predict', data)
        assert code == 200
        reply.pop('latency_ms')
        assert reply == want
        replies = []
        for payload in (_png(pixels), data):
            body = json.dumps({'img': base64.b64encode(payload).decode(),
                               'mods': sensors}).encode()
            code, reply = _call(url + '/predict_multi', body)
            assert code == 200
            reply.pop('latency_ms')
            replies.append(reply)
        assert replies[0] == replies[1]
    code, reply = _call(url + '/predict', lossless[0][:500])
    assert code == 400 and reply['error'].startswith('WebP')


def test_jpeg_gets_a_400(server):
    """A 12-bit JPEG, which the decoder refuses (as the JAX package's
    readers do), is a bad request."""
    _, url = server
    ok, jpg = cv2.imencode('.jpg', _request()[0])
    jpg = bytearray(jpg.tobytes())
    jpg[jpg.index(b'\xff\xc0') + 4] = 12
    code, reply = _call(url + '/predict', bytes(jpg))
    assert code == 400 and '12-bit' in reply['error']
    code, _ = _call(url + '/predict_multi', b'not json')
    assert code == 400


def test_a_jpeg_camera_answers_as_the_png_of_its_pixels(server):
    """A baseline JPEG camera payload decodes (on the detector's device)
    to what `cv2.imdecode` gives, and is answered as a PNG payload of
    those pixels is, on both routes."""
    _, url = server
    img, mods = _request()
    ok, jpg = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    pixels = _png(cv2.imdecode(jpg, cv2.IMREAD_COLOR))
    sensors = [base64.b64encode(_png(m)).decode() for m in mods]
    for route in ('/predict', '/predict_multi'):
        replies = []
        for camera in (jpg.tobytes(), pixels):
            body = camera if route == '/predict' else json.dumps(
                {'img': base64.b64encode(camera).decode(),
                 'mods': sensors}).encode()
            code, reply = _call(url + route, body)
            assert code == 200, reply
            reply.pop('latency_ms')
            replies.append(reply)
        assert replies[0] == replies[1], route


@pytest.mark.parametrize('coding', ['progressive', 'arithmetic',
                                    'arithmetic progressive'])
def test_other_jpeg_codings_answer_as_the_baseline(server, coding):
    """A progressive or arithmetic-coded camera payload holding a
    baseline payload's coefficients gets a 200 and its detections."""
    _, url = server
    img, _ = _request()
    coefs, quant = enc.image_coefficients(img, 90)
    replies = []
    for kw in ({}, {'progressive': 'progressive' in coding,
                    'arithmetic': 'arithmetic' in coding}):
        code, reply = _call(url + '/predict',
                            enc.encode(coefs, quant, img.shape[:2], **kw))
        assert code == 200, reply
        reply.pop('latency_ms')
        replies.append(reply)
    assert replies[0] == replies[1]


def test_a_jpeg_sensor_decodes_on_the_detectors_device(server,
                                                        monkeypatch):
    """8-bit JPEG sensor payloads decode as `cv2.IMREAD_UNCHANGED` gives
    them, on the worker thread, with the detector's device (where a
    JPEG's pixels are made), and are answered as `inference_detector`
    answers those pixels."""
    det, url = server
    img, mods = _request()
    jpgs = [cv2.imencode('.jpg', ((m - 19900) // 100).astype(np.uint8))[1]
            .tobytes() for m in mods]
    calls = []

    def decode(data, flag, device):
        calls.append((flag, device, threading.current_thread().name))
        return loading.decode(data, flag, device)

    monkeypatch.setattr(serve, 'decode', decode)
    body = json.dumps({'img': base64.b64encode(_png(img)).decode(),
                       'mods': [base64.b64encode(j).decode()
                                for j in jpgs]}).encode()
    code, reply = _call(url + '/predict_multi', body)
    assert code == 200, reply
    assert [c[:2] for c in calls] == [('unchanged', det.device)] * 2
    assert all(c[2].startswith('model') for c in calls)
    sensors = [serve._sensor(det.data, name, cv2.imdecode(
        np.frombuffer(j, np.uint8), cv2.IMREAD_UNCHANGED))
        for name, j in zip(det.data.modalities, jpgs)]
    want = inference_detector(det, img, sensors)
    assert len(want['labels']) and reply['labels'] == want['labels'].tolist()
    np.testing.assert_allclose(reply['boxes'], want['boxes'].reshape(-1, 4),
                               atol=0.01)
    np.testing.assert_allclose(reply['scores'], want['scores'], atol=1e-4)


def _replies_equal(reply, want):
    assert reply['labels'] == want['labels'].tolist()
    np.testing.assert_allclose(reply['boxes'], want['boxes'].reshape(-1, 4),
                               atol=0.01)
    np.testing.assert_allclose(reply['scores'], want['scores'], atol=1e-4)


def test_a_lossless_camera_answers_as_inference_detector(server):
    """A lossless RGB camera payload (SOF3, which the JAX server's
    `cv2.imdecode` reads as BGR) is answered on both routes as
    `inference_detector` answers `cv2`'s decode of it."""
    det, url = server
    img, mods = _request()
    data = enc.encode_lossless(img[..., ::-1], predictor=7, restart=90 * 3)
    pixels = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(pixels, img)
    code, reply = _call(url + '/predict', data)
    assert code == 200, reply
    _replies_equal(reply, inference_detector(det, pixels))
    body = json.dumps({'img': base64.b64encode(data).decode(),
                       'mods': [base64.b64encode(_png(m)).decode()
                                for m in mods]}).encode()
    code, reply = _call(url + '/predict_multi', body)
    assert code == 200, reply
    _replies_equal(reply, inference_detector(det, pixels, mods))
    grey = enc.encode_lossless(img[..., 0])
    code, reply = _call(url + '/predict', grey)    # cv2 reads it no colour
    assert code == 400 and 'lossless' in reply['error']


def test_lossless_sensors_answer_as_inference_detector():
    """Lossless sensor payloads to a three-stream STF model: lidar and
    radar as 3-component frames (`cv2.IMREAD_UNCHANGED` reads them BGR; the
    radar's channel 0 dropped as the loader drops it), the gated image as
    a 1-component frame (read grey [H, W], given its channel axis).
    Answered as `inference_detector` answers `cv2`'s decodes of them."""
    from hrfuser_tpu_torch.apis.inference import Detector
    from hrfuser_tpu_torch.configs import presets
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    cfg = presets._tiny(presets.hrfuser_backbone(
        channels=(8, 16, 24, 32), heads=(1, 2, 2, 4), num_modalities=3,
        mod_in_channels=(3, 2, 1)))
    torch.manual_seed(0)
    model = CascadeRCNN(dataclasses.replace(cfg, roi=dataclasses.replace(
        cfg.roi, num_classes=3))).eval()           # STF's three classes
    data = dataclasses.replace(
        get_experiment('cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod').data,
        img_scale=(96, 64))
    det = Detector(model, data, torch.device('cpu'))
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (60, 90, 3)).astype(np.uint8)
    sensors = [enc.encode_lossless(rng.integers(0, 256, (60, 90, 3)),
                                   predictor=4, restart=90),
               enc.encode_lossless(rng.integers(0, 256, (60, 90, 3)),
                                   predictor=6),
               enc.encode_lossless(rng.integers(0, 256, (60, 90)),
                                   predictor=1, pt=1, restart=90 * 2)]
    srv = serve.make_server(det, '127.0.0.1', 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f'http://127.0.0.1:{srv.server_address[1]}'
        body = json.dumps({'img': base64.b64encode(_png(img)).decode(),
                           'mods': [base64.b64encode(s).decode()
                                    for s in sensors]}).encode()
        code, reply = _call(url + '/predict_multi', body)
        assert code == 200, reply
        lidar, radar, gated = (cv2.imdecode(np.frombuffer(s, np.uint8),
                                            cv2.IMREAD_UNCHANGED)
                               for s in sensors)
        assert gated.shape == (60, 90) and lidar.shape == (60, 90, 3)
        _replies_equal(reply, inference_detector(det, img, [
            lidar.astype(np.float32), radar[..., 1:].astype(np.float32),
            gated[..., None].astype(np.float32)]))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_grey_sensor_pngs_get_a_channel_axis(dtype):
    """A gated image arrives as a grey PNG: [H, W, 1], uint16 kept as
    integers (`sensor_values` reads them as intensities), uint8 as
    float."""
    grey = np.random.default_rng(3).integers(0, 256, (5, 7)).astype(dtype)
    data = get_experiment('cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod').data
    m = serve._sensor(data, 'gated', imdecode(_png(grey), unchanged=True))
    assert m.shape == (5, 7, 1)
    assert m.dtype == (np.uint16 if dtype == np.uint16 else np.float32)
    np.testing.assert_array_equal(m[..., 0], grey)


def test_camera_only_server_takes_no_sensor_pngs():
    det = init_detector('tiny_camera_test', 'cpu', seed=0)
    det.data = dataclasses.replace(det.data, img_scale=(96, 64))
    srv = serve.make_server(det, '127.0.0.1', 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f'http://127.0.0.1:{srv.server_address[1]}'
        img, _ = _request()
        code, reply = _call(url + '/predict', _png(img))
        assert code == 200
        assert reply['labels'] == inference_detector(det, img)[
            'labels'].tolist()
        body = json.dumps({'img': base64.b64encode(_png(img)).decode()})
        code, multi = _call(url + '/predict_multi', body.encode())
        assert code == 200 and multi['labels'] == reply['labels']
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_stf_server_takes_three_sensor_pngs():
    """A three-modality model on STF data: lidar and radar as stored (two
    3-channel uint16 PNGs; the radar's empty channel 0 dropped as the
    loader drops it), the gated image as a grey uint16 PNG. Replies
    equal `inference_detector` on the arrays the loader would give; a
    wrong number of sensor PNGs gets a 400."""
    from hrfuser_tpu_torch.apis.inference import Detector
    from hrfuser_tpu_torch.configs import presets
    from hrfuser_tpu_torch.models.detectors.cascade_rcnn import CascadeRCNN
    cfg = presets._tiny(presets.hrfuser_backbone(
        channels=(8, 16, 24, 32), heads=(1, 2, 2, 4), num_modalities=3,
        mod_in_channels=(3, 2, 1)))
    model = CascadeRCNN(dataclasses.replace(cfg, roi=dataclasses.replace(
        cfg.roi, num_classes=3))).eval()           # STF's three classes
    data = dataclasses.replace(
        get_experiment('cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod').data,
        img_scale=(96, 64))
    det = Detector(model, data, torch.device('cpu'))
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (60, 90, 3)).astype(np.uint8)
    lidar, radar = (rng.integers(19900, 21000, (60, 90, 3)).astype(
        np.uint16) for _ in range(2))
    gated = rng.integers(0, 1024, (60, 90)).astype(np.uint16)
    srv = serve.make_server(det, '127.0.0.1', 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f'http://127.0.0.1:{srv.server_address[1]}'
        pngs = [base64.b64encode(_png(m)).decode()
                for m in (lidar, radar, gated)]
        body = json.dumps({'img': base64.b64encode(_png(img)).decode(),
                           'mods': pngs}).encode()
        code, reply = _call(url + '/predict_multi', body)
        assert code == 200, reply
        want = inference_detector(det, img, [lidar, radar[..., 1:],
                                             gated[..., None]])
        assert reply['labels'] == want['labels'].tolist()
        np.testing.assert_allclose(reply['boxes'],
                                   want['boxes'].reshape(-1, 4), atol=0.01)
        body = json.dumps({'img': base64.b64encode(_png(img)).decode(),
                           'mods': pngs[:2]}).encode()
        code, reply = _call(url + '/predict_multi', body)
        assert code == 400 and '3 (lidar, radar, gated)' in reply['error']
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_requests_with_the_wrong_sensor_channels_raise(server):
    """`inference_detector` checks a request's sensor images against the
    model's streams before preprocessing (the server answers 400)."""
    det, url = server
    img, mods = _request()
    with pytest.raises(ValueError, match=r'\[3\] channels'):
        inference_detector(det, img, mods[:1])
    with pytest.raises(ValueError, match=r'\[3, 2\] channels'):
        inference_detector(det, img, [mods[0], mods[1][..., :2]])
    body = json.dumps({'img': base64.b64encode(_png(img)).decode(),
                       'mods': [base64.b64encode(_png(mods[0])).decode()]})
    code, reply = _call(url + '/predict_multi', body.encode())
    assert code == 400 and 'sensor images' in reply['error']


def test_serve_takes_input_hw(monkeypatch):
    """`--input-hw H W` (the JAX server's init shape) is accepted: the
    warm-up call runs `predict` on that grid, padded to /32."""
    det = init_detector(NAME, 'cpu', seed=0)
    shapes = []
    real = type(det).__call__

    def call(self, img, mods, *args):
        shapes.append((tuple(img.shape), [tuple(m.shape) for m in mods]))
        return real(self, img, mods, *args)
    monkeypatch.setattr(type(det), '__call__', call)
    assert serve.warm_up(det, (60, 90)) > 0
    assert shapes == [((1, 64, 96, 3), [(1, 64, 96, 3)] * 2)]

    class Stub:
        warm_up_s = 0.0

        def serve_forever(self):
            pass

        def server_close(self):
            pass
    seen = {}
    monkeypatch.setattr(serve, 'init_detector', lambda *a, **k: det)
    monkeypatch.setattr(serve, 'make_server', lambda d, host, port, hw: (
        seen.update(hw=hw), Stub())[1])
    serve.main([NAME, '--device', 'cpu', '--input-hw', '60', '90'])
    assert seen['hw'] == [60, 90]
