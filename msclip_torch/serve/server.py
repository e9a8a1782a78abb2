"""Threaded HTTP inference server over a loaded serving bundle (the
counterpart of ``msclip_tpu/serve/server.py``, with the same routes and
JSON).

Endpoints (JSON out; stdlib only, no web framework):

* ``POST /v1/embed/image``: body JPEG/PNG bytes (any ``image/*`` content
  type) or a raw ``.npy`` uint8 HWC array. Decoded and resized/cropped on
  the handler thread (PIL, as the eval transform), then coalesced with
  concurrent requests by the :class:`DynamicBatcher`. Returns
  ``{"embedding": [...], "dim": E}``.
* ``POST /v1/embed/text``: body ``{"texts": ["a photo of ..."]}`` or
  ``{"text": "..."}``. Returns ``{"embeddings": [[...]], "dim": E}``.
* ``POST /v1/classify?topk=k``: image body as above; needs a bundle
  exported with a classifier. Returns the top-k
  ``{"topk": [{"label", "index", "logit", "prob"}...]}`` with the
  reference logit convention ``100 * feats @ W``.
* ``POST /v1/rank``: ``{"texts": [...], "image": <base64>,
  "content_type": "image/jpeg"}``. Zero-shot ranking of the caller's
  candidate texts against the image (cosine similarity x 100; both sides
  L2-normalized here).
* ``GET /healthz``: liveness and the bundle's facts.
* ``GET /stats``: the batchers' coalescing counters.

Scaling: one server process per card behind any HTTP load balancer;
embeddings are stateless.
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .batcher import DynamicBatcher
from .export import ServingModel, pil_to_uint8


class _Httpd(ThreadingHTTPServer):
    """socketserver's default listen backlog is 5: a burst of concurrent
    clients (24 simultaneous connects) overflows the accept queue and the
    kernel resets the excess, so callers see ConnectionResetError with
    nothing in the server log. A deep backlog is what a dynamic-batching
    server wants: connections queue in the kernel while the batcher drains
    them in bucket-sized waves."""

    request_queue_size = 256


def _decode_image(body: bytes, content_type: str, size: int) -> np.ndarray:
    """Request body -> uint8 [size, size, 3] crop."""
    if "npy" in content_type or body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        # channels are checked before the fast path: a (size, size, 4)
        # array passed through would fail in the batcher's np.stack and
        # fail every request coalesced into the same batch with it
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError("npy image must be uint8 HWC with 3 channels")
        if arr.shape[0] == size and arr.shape[1] == size:
            return arr
        from PIL import Image

        return pil_to_uint8(Image.fromarray(arr), size)
    from PIL import Image

    return pil_to_uint8(Image.open(io.BytesIO(body)), size)


class InferenceServer:
    """Owns the model, the per-modality batchers, and the HTTP server."""

    def __init__(self, model: ServingModel, host: str = "127.0.0.1",
                 port: int = 0, max_wait_ms: float = 5.0):
        self.model = model
        max_batch = model.buckets[-1]
        self._image_batcher = DynamicBatcher(
            model.encode_image, max_batch=max_batch,
            max_wait_ms=max_wait_ms, name="image-batcher",
        )
        self._text_batcher = DynamicBatcher(
            model.encode_text, max_batch=max_batch,
            max_wait_ms=max_wait_ms, name="text-batcher",
        )
        self._httpd = _Httpd((host, port), self._make_handler())
        self._thread = None

    # -- lifecycle -------------------------------------------------------
    @property
    def address(self):
        return self._httpd.server_address

    def start(self):
        """Serve in a background thread (tests, embedding in a process)."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-server", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        host, port = self.address
        logging.info(f"=> serving on http://{host}:{port}")
        self._httpd.serve_forever()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self._image_batcher.close()
        self._text_batcher.close()

    # -- request handling --------------------------------------------------
    def _embed_image(self, body: bytes, content_type: str) -> dict:
        crop = _decode_image(body, content_type, self.model.image_size)
        feats = self._image_batcher(crop)
        return {"embedding": feats.tolist(), "dim": self.model.embed_dim}

    def _parse_and_tokenize(self, req: dict):
        """Texts of /v1/embed/text and /v1/rank: ``(texts, tokens [N, T]
        int32)``; a malformed texts field raises ValueError (a 400)."""
        texts = req.get("texts") or [req["text"]]
        if (not isinstance(texts, list) or not texts
                or not all(isinstance(t, str) for t in texts)):
            raise ValueError("texts must be a non-empty list of strings")
        return texts, self.model.tokenize(texts)

    def _embed_text(self, body: bytes) -> dict:
        _, tokens = self._parse_and_tokenize(json.loads(body))
        futs = [self._text_batcher.submit(t) for t in tokens]
        embs = [f.result().tolist() for f in futs]
        return {"embeddings": embs, "dim": self.model.embed_dim}

    def _rank(self, body: bytes) -> dict:
        """Zero-shot ranking of caller-supplied texts against one image:
        /v1/classify with the prompt ensemble replaced by the caller's
        candidate texts."""
        import base64

        req = json.loads(body)
        texts, tokens = self._parse_and_tokenize(req)
        image = base64.b64decode(req["image"])
        crop = _decode_image(image, req.get("content_type", ""),
                             self.model.image_size)
        img_fut = self._image_batcher.submit(crop)
        txt_futs = [self._text_batcher.submit(t) for t in tokens]
        feat = img_fut.result()
        feat = feat / max(float(np.linalg.norm(feat)), 1e-12)
        embs = np.stack([f.result() for f in txt_futs])
        embs = embs / np.maximum(
            np.linalg.norm(embs, axis=-1, keepdims=True), 1e-12
        )
        logits = 100.0 * embs @ feat
        e = np.exp(logits - logits.max())
        probs = e / e.sum()
        order = np.argsort(logits)[::-1]
        return {"ranking": [
            {"index": int(i), "text": texts[i],
             "logit": float(logits[i]), "prob": float(probs[i])}
            for i in order
        ]}

    def _classify(self, body: bytes, content_type: str, topk: int) -> dict:
        if self.model.classifier is None:
            raise ValueError("bundle has no classifier; export with "
                             "--classify-prompts to enable /v1/classify")
        crop = _decode_image(body, content_type, self.model.image_size)
        feats = self._image_batcher(crop)
        logits = 100.0 * feats @ self.model.classifier
        e = np.exp(logits - logits.max())
        probs = e / e.sum()
        order = np.argsort(logits)[::-1][:topk]
        names = self.model.classnames
        return {"topk": [
            {"index": int(i),
             "label": names[i] if names else str(int(i)),
             "logit": float(logits[i]),
             "prob": float(probs[i])}
            for i in order
        ]}

    def _stats(self) -> dict:
        return {"image": self._image_batcher.stats,
                "text": self._text_batcher.stats}

    def _health(self) -> dict:
        return {"status": "ok",
                "buckets": self.model.buckets,
                "image_size": self.model.image_size,
                "embed_dim": self.model.embed_dim,
                "has_classifier": self.model.classifier is not None}

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: a response goes out as two writes (headers,
            # body), and on a kept-alive connection Nagle's algorithm holds
            # the body until the client's delayed ACK of the headers (~40
            # ms on Linux)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route through logging
                logging.debug("http: " + fmt % args)

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server._health())
                elif self.path == "/stats":
                    self._send(200, server._stats())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                path = self.path.split("?")[0]
                try:
                    if path == "/v1/embed/image":
                        self._send(200, server._embed_image(body, ctype))
                    elif path == "/v1/embed/text":
                        self._send(200, server._embed_text(body))
                    elif path == "/v1/rank":
                        self._send(200, server._rank(body))
                    elif path == "/v1/classify":
                        topk = 5
                        if "?" in self.path and "topk=" in self.path:
                            topk = int(self.path.split("topk=")[1])
                        self._send(
                            200, server._classify(body, ctype, topk)
                        )
                    else:
                        self._send(404, {"error": f"no route {path}"})
                except (ValueError, KeyError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # batcher/device failures
                    logging.exception("request failed")
                    self._send(500, {"error": str(e)})

        return Handler
