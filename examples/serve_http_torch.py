"""Worked example: a batching HTTP inference server over the PyTorch/CUDA
port's serving path (the port's counterpart of examples/serve_http.py).

A stdlib HTTP server whose handler threads enqueue requests and a single
dispatch loop that coalesces them into fixed-size device batches (static
shapes), runs the port's `serving_forward` on the card (or, with --device
cpu, its plain PyTorch path), and fans the logits back out. Padding rides
the batch dimension, so a lone request still gets the batch's latency, and
a burst gets its throughput.

Run (the JAX example's sizes, vit_tiny at 32x32):

    python examples/serve_http_torch.py --port 8900 [--device cpu] &
    curl -s -X POST --data-binary @image.rgb http://localhost:8900/classify
    # body: H*W*3 raw uint8 bytes (the demo sends 32x32x3); response: JSON
    # {"label": int, "top5": [...]} per request

`examples/serve_http_torch.py --selftest` starts the server, fires
concurrent requests at it, and checks the answers against a direct forward.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Batcher:
    """Coalesce single requests into fixed [B, ...] device batches.

    submit() blocks the calling (handler) thread until its result is ready;
    the dispatch loop waits at most `max_wait_ms` to fill a batch, then pads
    the tail with copies of the last request (static shapes: one batch
    shape for every traffic level).
    """

    def __init__(self, forward, batch_size: int, max_wait_ms: float = 5.0):
        self.forward = forward
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, pixels_u8: np.ndarray) -> np.ndarray:
        done = threading.Event()
        slot = {}
        self.q.put((pixels_u8, slot, done))
        # bounded wait: if the dispatch loop died or close() drained the
        # queue, the handler thread must not block forever
        while not done.wait(timeout=1.0):
            if self._stop.is_set() or not self.thread.is_alive():
                raise RuntimeError("batcher is shut down")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["logits"]

    def close(self):
        self._stop.set()
        self.thread.join(timeout=5)
        self._fail_pending("batcher is shut down")

    def _fail_pending(self, msg: str):
        while True:
            try:
                _, slot, done = self.q.get_nowait()
            except queue.Empty:
                return
            slot["error"] = msg
            done.set()

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=timeout))
                except queue.Empty:
                    break
            try:
                pixels = np.stack([b[0] for b in batch])
                pad = self.batch_size - len(batch)
                if pad:
                    pixels = np.concatenate(
                        [pixels, np.repeat(pixels[-1:], pad, axis=0)])
                logits = np.asarray(self.forward(pixels))
                for i, (_, slot, done) in enumerate(batch):
                    slot["logits"] = logits[i]
                    done.set()
            except Exception as e:  # surface to every waiting handler
                for _, slot, done in batch:
                    slot["error"] = repr(e)
                    done.set()
        self._fail_pending("batcher is shut down")


def build_forward(batch_size: int, device: str):
    import torch

    from vit_pruning_tpu_torch.configs import PruneConfig, vit_tiny
    from vit_pruning_tpu_torch.models.convert import check_device
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
    from vit_pruning_tpu_torch.serving import serving_forward

    dev = check_device(device)
    config = vit_tiny(num_labels=100)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", top_k=8)
    params = init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(0), dev)
    # deployment would restore_checkpoint(...) here
    side = config.image_size

    @torch.no_grad()
    def forward(pixels_hw3_u8: np.ndarray) -> np.ndarray:
        chw = torch.from_numpy(np.ascontiguousarray(pixels_hw3_u8.transpose(0, 3, 1, 2)))
        return serving_forward(params, chw.to(dev), config, pcfg)["logits"].float().cpu().numpy()

    # run once up front, so that the first request does not pay the kernels' build and load
    forward(np.zeros((batch_size, side, side, 3), np.uint8))
    return forward, side


def make_server(port: int, batcher: Batcher, side: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            if self.path != "/classify":
                self.send_response(404)
                self.end_headers()
                self.wfile.write(b"POST /classify")
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if len(body) != side * side * 3:
                self.send_response(400)
                self.end_headers()
                self.wfile.write(
                    f"expected {side * side * 3} raw uint8 bytes "
                    f"({side}x{side}x3), got {len(body)}".encode())
                return
            img = np.frombuffer(body, np.uint8).reshape(side, side, 3)
            logits = batcher.submit(img)
            top5 = np.argsort(logits)[::-1][:5]
            out = json.dumps({
                "label": int(top5[0]),
                "top5": [int(i) for i in top5],
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(out)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8900)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' asks for the CPU)")
    args = ap.parse_args()

    forward, side = build_forward(args.batch_size, args.device)
    batcher = Batcher(forward, args.batch_size)
    server = make_server(args.port, batcher, side)
    port = server.server_address[1]  # --port 0: a free port the system picks

    if not args.selftest:
        print(f"serving on http://127.0.0.1:{port}/classify "
              f"(POST {side}x{side}x3 raw uint8)")
        server.serve_forever()
        return

    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    import urllib.request

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (12, side, side, 3), np.uint8)
    results = [None] * len(imgs)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/classify",
            data=imgs[i].tobytes(), method="POST")
        with urllib.request.urlopen(req) as r:
            results[i] = json.loads(r.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(imgs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    ok = 0
    for i in range(len(imgs)):
        want = np.asarray(forward(
            np.repeat(imgs[i:i + 1], args.batch_size, axis=0)))[0]
        ok += int(results[i]["label"] == int(want.argmax()))
    server.shutdown()
    batcher.close()
    print(f"selftest: {ok}/{len(imgs)} labels match the direct forward")
    if ok != len(imgs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
