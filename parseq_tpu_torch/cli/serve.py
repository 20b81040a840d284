"""Online STR serving of the PyTorch port: an HTTP front over the batching
InferenceServer (counterpart of parseq_tpu/cli/serve.py). Stdlib only:

    python -m parseq_tpu_torch.cli.serve <checkpoint> [--port 8500] [--host 127.0.0.1]
        [--max_batch 32] [--max_wait_ms 2.0] [--int8] [--no_warmup] [--device cuda|cpu]
        [model_override:type=value ...]

`checkpoint` is a reference PyTorch .pt or .ckpt file, a checkpoint the
port's trainer wrote, a JAX package checkpoint, or `pretrained=<experiment>`
(utils/pretrained.py); `--int8` serves with the ViT encoder quantized.
The default device is cuda; with no GPU the command fails unless --device
cpu is given.

Endpoints:
    GET  /healthz          -> {"ok": true, "stats": {...}}
    POST /v1/read          body = image bytes (JPEG/PNG/...)
                           -> {"text": ..., "confidence": ...}

Concurrent requests are coalesced into batches of a power-of-two ladder
(see serve/server.py). Images are decoded and resized in the handler's
thread: JPEGs by the native decoder (data/native/jpeg_decode.cpp), others by
PIL.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from parseq_tpu_torch.utils.config import parse_model_args
from parseq_tpu_torch.utils.registry import load_from_checkpoint


def make_handler(server, bundle):
    from parseq_tpu_torch.data.transforms import decode_u8

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                self._json(200, {'ok': True, 'stats': server.stats})
            else:
                self._json(404, {'error': 'unknown path'})

        def do_POST(self):
            if self.path != '/v1/read':
                self._json(404, {'error': 'unknown path'})
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                # JPEG: native decode+resize (bit-identical to the PIL
                # path, data/native/jpeg_decode.cpp); anything else via PIL.
                arr = decode_u8(self.rfile.read(n), bundle.img_size)
            except Exception as e:  # noqa: BLE001 - bad input -> client error
                self._json(400, {'error': f'{type(e).__name__}: {e}'})
                return
            try:
                text, conf = server.submit(arr).result(timeout=30)
                self._json(200, {'text': text, 'confidence': conf})
            except TimeoutError:
                self._json(504, {'error': 'inference timed out (server overloaded)'})
            except Exception as e:  # noqa: BLE001 - server-side failure
                self._json(500, {'error': f'{type(e).__name__}: {e}'})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('checkpoint',
                    help='PyTorch .pt / .ckpt file, JAX .ckpt or pretrained=<experiment>')
    ap.add_argument('--port', type=int, default=8500)
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--max_batch', type=int, default=32)
    ap.add_argument('--max_wait_ms', type=float, default=2.0)
    ap.add_argument('--int8', action='store_true',
                    help='int8 encoder serving path (ViT-backed models)')
    ap.add_argument('--no_warmup', action='store_true')
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    ap.add_argument('model_args', nargs='*', help='Model overrides key:type=value')
    args = ap.parse_args(argv)

    if torch.device(args.device).type == 'cuda' and not torch.cuda.is_available():
        ap.error('no CUDA device is available; pass --device cpu to run on the CPU')
    bundle = load_from_checkpoint(args.checkpoint, device=args.device,
                                  **parse_model_args(args.model_args))
    if args.int8:
        from parseq_tpu_torch.ops.quant import quantize_bundle

        bundle = quantize_bundle(bundle)

    from parseq_tpu_torch.serve import InferenceServer

    srv = InferenceServer(bundle, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms).start()
    if not args.no_warmup:
        print(f'warming up rungs {srv.rungs} ...', flush=True)
        srv.warmup()
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv, bundle))
    print(f'serving {bundle.name} on http://{args.host}:{args.port} on {bundle.device} '
          f'(rungs {srv.rungs}, wait {args.max_wait_ms} ms)', flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.stop()


if __name__ == '__main__':
    main()
