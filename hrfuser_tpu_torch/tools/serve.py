"""Minimal HTTP inference server.

Port of `tools/serve.py` (the reference's torchserve deployment path,
`tools/deployment/mmdet2torchserve.py` + `mmdet_handler.py`): loads a
config (+ checkpoint), answers one warm-up request, then serves
detections over HTTP.

`ThreadingHTTPServer` runs each request on a thread of its own. The
model calls all go to one long-lived worker thread instead: that
serialises them (the kernels' launch counters and the per-block
folded-weight caches, `layers/common.cached`, are module state that
concurrent calls would race on), and a PyTorch call on a thread that has
not called before costs about 200 ms more on the card (measured by
`chip_smoke.py` phase 6d).

    POST /predict        body = the camera image's bytes (JPEG, PNG,
                         TIFF, BMP, PNM, PAM, PFM, Sun raster, Radiance
                         HDR or WebP)
    POST /predict_multi  json {"img": <b64 camera image>,
                               "mods": [<b64 png or jpeg>, ...]}
                         (sensor PNGs in the config's modality order, as
                         stored offline: uint16 projections, dequantized
                         on the device, STF's radar with its empty
                         channel 0 dropped as the loader drops it; STF's
                         gated image a grey PNG of intensities; none for
                         a camera-only config)
        -> {"boxes": [[x1, y1, x2, y2], ...], "scores": [...],
            "labels": [...], "class_names": [...], "latency_ms": t}
    GET  /healthz        -> {"status": "ok"}

Camera payloads are read as the JAX server's `cv2.imdecode` reads them,
the decoder chosen by the first bytes (`data/pipelines/loading.imdecode`,
`loading.READS`): JPEG (any coding: baseline, progressive, arithmetic,
lossless), PNG (any type), TIFF, BMP, PBM / PGM / PPM, PAM, PFM, Sun
raster, Radiance HDR or WebP (lossless, lossy, with alpha, or an
animation's first frame). A JPEG is entropy-decoded on the worker thread and its
pixels are made on the detector's device, where the model reads them
without a copy back to the host; the other formats decode on the worker
thread's host and are copied. Sensor payloads decode on the worker
thread as `cv2.IMREAD_UNCHANGED` does (`data/pipelines/loading.decode`:
a PNG on the host, a JPEG's pixels on the detector's device, copied back
to the host as the dataset loader's are). A payload that does not decode
(a 12-bit JPEG, a lossless one that `cv2` reads no colour from, a cut
BMP or WebP) gets a 400 whose text names the format it met, or says "unknown
image signature".

    python -m hrfuser_tpu_torch.tools.serve \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion --dtype bf16 \\
        [--checkpoint CKPT] [--port 8500]
    curl -X POST --data-binary @img.jpg localhost:8500/predict
"""

from __future__ import annotations

import argparse
import base64
import json
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from hrfuser_tpu_torch.apis.inference import (inference_detector,
                                              init_detector)
from hrfuser_tpu_torch.data.pipelines.loading import decode, imdecode
from hrfuser_tpu_torch.tools.test import DTYPES


def predict(detector, camera: bytes, sensors):
    """Decode a request's payloads and detect; runs on the worker thread.
    The camera's pixels are made on the detector's device and stay there;
    `sensors`, (stream name, payload) pairs, decode as `cv2.IMREAD_UNCHANGED`
    does to host arrays, a JPEG's pixels made on the device too."""
    mods = [_sensor(detector.data, name, decode(data, 'unchanged',
                                                detector.device))
            for name, data in sensors] or None
    return inference_detector(detector, imdecode(camera, detector.device),
                              mods)


def build_handler(detector, worker: ThreadPoolExecutor):
    class_names = list(detector.data.classes)
    modalities = detector.data.modalities

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, payload):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def log_message(self, fmt, *a):            # quiet access log
            pass

        def do_GET(self):
            if self.path == '/healthz':
                self._json(200, {'status': 'ok'})
            else:
                self._json(404, {'error': 'unknown path'})

        def do_POST(self):
            if self.path not in ('/predict', '/predict_multi'):
                self._json(404, {'error': 'unknown path'})
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                body = self.rfile.read(n)
                t0 = time.time()
                if self.path == '/predict':
                    img, sensors = body, []
                else:
                    req = json.loads(body)
                    img = base64.b64decode(req['img'])
                    sensors, names = req.get('mods', []), modalities
                    if sensors and len(sensors) != len(names):
                        raise ValueError(
                            f'{len(sensors)} sensor images; the config '
                            f'takes {len(names)} ({", ".join(names)})')
                    sensors = [(name, base64.b64decode(m))
                               for name, m in zip(names, sensors)]
                det = worker.submit(predict, detector, img, sensors).result()
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {'error': str(e)})
                return
            except Exception as e:                 # noqa: BLE001
                traceback.print_exc()
                self._json(500, {'error': f'{type(e).__name__}: {e}'})
                return
            self._json(200, {
                'boxes': np.round(det['boxes'], 2).tolist(),
                'scores': np.round(det['scores'], 4).tolist(),
                'labels': det['labels'].tolist(),
                'class_names': [class_names[i] for i in det['labels']],
                'latency_ms': round((time.time() - t0) * 1e3, 1),
            })

    return Handler


# channels of a stored sensor PNG that the dataset loader drops: STF's
# radar 'yzv' projection (`hrfuser_tpu/data/loader.py:43-45`)
_DROPPED = {('stf', 'radar'): 0}


def _sensor(data, name: str, img: np.ndarray) -> np.ndarray:
    """A decoded sensor PNG of stream `name` as [H, W, C]: channels the
    loader drops are dropped, uint16 values stay integers
    (`device_pipeline.sensor_values` reads them), other depths are taken
    as raw values; a grey PNG gets its channel axis."""
    if img.ndim == 2:
        img = img[..., None]
    drop = _DROPPED.get((data.dataset, name))
    if drop is not None:
        img = np.delete(img, drop, axis=-1)
    return img if img.dtype == np.uint16 else img.astype(np.float32)


def warm_up(detector, input_hw=None) -> float:
    """One `predict` on zeros at the model grid before traffic; returns
    seconds. The grid is `input_hw` (the JAX server's `--input-hw`, the
    shape it initialises at) or the config's `img_scale`, padded to its
    divisor, as a request's images are."""
    w, h = detector.data.img_scale
    d = detector.data.pad_divisor
    h, w = (-(-v // d) * d for v in input_hw or (h, w))
    bb = detector.cfg.backbone
    t0 = time.time()
    detector(np.zeros((1, h, w, 3), np.float32),
             [np.zeros((1, h, w, c), np.float32)
              for c in bb.mod_in_channels[:bb.num_fused_modalities]])
    return time.time() - t0


class Server(ThreadingHTTPServer):
    """The HTTP server and the one worker thread that runs the model."""

    def __init__(self, address, detector):
        self.worker = ThreadPoolExecutor(1, thread_name_prefix='model')
        super().__init__(address, build_handler(detector, self.worker))

    def server_close(self):
        super().server_close()
        self.worker.shutdown()


def make_server(detector, host: str = '127.0.0.1', port: int = 8500,
                input_hw=None) -> Server:
    """The server, bound, its worker warmed up by one request
    (`warm_up_s`, `warm_up`), not yet serving (`serve_forever`)."""
    server = Server((host, port), detector)
    server.warm_up_s = server.worker.submit(warm_up, detector,
                                            input_hw).result()
    return server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8500)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dtype', choices=sorted(DTYPES), default='f32')
    ap.add_argument('--input-hw', type=int, nargs=2, default=None,
                    help='model grid of the warm-up call')
    args = ap.parse_args(argv)

    detector = init_detector(args.config, args.device,
                             dtype=DTYPES[args.dtype],
                             checkpoint=args.checkpoint)
    server = make_server(detector, args.host, args.port, args.input_hw)
    print(f'[serve] warm-up request in {server.warm_up_s:.1f}s; '
          f'{len(detector.data.classes)} classes')
    print(f'[serve] listening on http://{args.host}:{args.port} '
          f'(POST /predict, /predict_multi; GET /healthz)')
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == '__main__':
    main()
