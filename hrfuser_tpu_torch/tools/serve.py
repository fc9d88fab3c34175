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

    POST /predict        body = JPEG or PNG bytes (BGR camera image)
    POST /predict_multi  json {"img": <b64 jpeg or png>,
                               "mods": [<b64 png>, ...]}
                         (sensor PNGs in the config's modality order, as
                         stored offline: uint16 projections, dequantized
                         on the device, STF's radar with its empty
                         channel 0 dropped as the loader drops it; STF's
                         gated image a grey PNG of intensities; none for
                         a camera-only config)
        -> {"boxes": [[x1, y1, x2, y2], ...], "scores": [...],
            "labels": [...], "class_names": [...], "latency_ms": t}
    GET  /healthz        -> {"status": "ok"}

Camera payloads are JPEG or PNG, as the JAX server's `cv2.imdecode`
takes them (`data/pipelines/loading.imdecode`, picked by the first
bytes). A JPEG is Huffman-decoded on the worker thread and its pixels
are made on the detector's device, where the model reads them without a
copy back to the host. Sensor payloads are PNG (`data/png.py`). A
payload that does not decode (a progressive JPEG, say) gets a 400 with
the reason.

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
from hrfuser_tpu_torch.data.pipelines.loading import imdecode
from hrfuser_tpu_torch.data.png import imdecode as png_decode
from hrfuser_tpu_torch.tools.test import DTYPES


def predict(detector, camera: bytes, mods):
    """Decode a camera payload on the detector's device and detect;
    runs on the worker thread."""
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
                    img, mods = body, None
                else:
                    req = json.loads(body)
                    img = base64.b64decode(req['img'])
                    pngs, names = req.get('mods', []), modalities
                    if pngs and len(pngs) != len(names):
                        raise ValueError(
                            f'{len(pngs)} sensor images; the config takes '
                            f'{len(names)} ({", ".join(names)})')
                    mods = [_sensor(detector.data, name,
                                    png_decode(base64.b64decode(m),
                                               unchanged=True))
                            for name, m in zip(names, pngs)] or None
                det = worker.submit(predict, detector, img, mods).result()
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


def warm_up(detector) -> float:
    """One request at the model grid before traffic; returns seconds."""
    w, h = detector.data.img_scale
    t0 = time.time()
    inference_detector(detector, np.zeros((h, w, 3), np.uint8),
                       [np.zeros((h, w, c), np.float32)
                        for c in detector.cfg.backbone.mod_in_channels])
    return time.time() - t0


class Server(ThreadingHTTPServer):
    """The HTTP server and the one worker thread that runs the model."""

    def __init__(self, address, detector):
        self.worker = ThreadPoolExecutor(1, thread_name_prefix='model')
        super().__init__(address, build_handler(detector, self.worker))

    def server_close(self):
        super().server_close()
        self.worker.shutdown()


def make_server(detector, host: str = '127.0.0.1',
                port: int = 8500) -> Server:
    """The server, bound, its worker warmed up by one request
    (`warm_up_s`), not yet serving (`serve_forever`)."""
    server = Server((host, port), detector)
    server.warm_up_s = server.worker.submit(warm_up, detector).result()
    return server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8500)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dtype', choices=sorted(DTYPES), default='f32')
    args = ap.parse_args(argv)

    detector = init_detector(args.config, args.device,
                             dtype=DTYPES[args.dtype],
                             checkpoint=args.checkpoint)
    server = make_server(detector, args.host, args.port)
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
