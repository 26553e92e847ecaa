"""Dynamic-batching serving front end (port of
``focused_attention_vit_tpu/serve.py``).

- :class:`BatchingServer` packs concurrent requests of any size into full
  device batches of a :class:`~.infer.Predictor`; a request larger than the
  batch runs alone through the predictor's own chunking.
- :class:`HTTPFrontend` exposes it over HTTP with the standard library:
  ``POST /predict`` takes an ``.npy`` of uint8 ``[n, h, w, 3]`` and returns
  an ``.npy`` of float32 ``[n, C]`` probabilities; ``GET /healthz`` and
  ``GET /stats`` give liveness and the coalescer's counters.
- ``python -m focused_attention_vit_tpu_torch.serve --weights PATH ...``
  serves a model from a ``.pt``/``.pth`` state dict or a ``.npz`` of JAX
  params; ``--checkpoint_dir DIR`` instead serves a training checkpoint
  directory's params sidecar, the port's ``params_latest.pt`` or a JAX
  run's ``params_latest.msgpack`` (:func:`setup` builds the predictor,
  :func:`main` serves it); ``--export_artifact DIR`` writes the
  predictor's serving artifact (:mod:`.export`) instead of serving, and
  ``--from_export DIR`` serves such an artifact.
- ``--num_devices N`` (None or <= 0: every device; one with ``--device
  cpu``) and ``--tp T`` serve on a ``(data, model)`` mesh, JAX's rule: one
  device at ``tp=1`` is no mesh. The command starts its ranks as the
  training CLI does (:mod:`.parallel.launch`; gloo with ``--device cpu``,
  NCCL on the cards), or joins them under ``torchrun``: rank 0 owns the
  :class:`BatchingServer` and the :class:`HTTPFrontend`, the others run
  :meth:`~.infer.Predictor.follow`, and Ctrl-C (SIGINT) on rank 0, or on
  every process, stops them all. ``--from_export`` ignores the mesh flags
  and ``--export_artifact`` refuses a mesh, as in JAX.

``submit`` is thread-safe; results come back as
:class:`concurrent.futures.Future`.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


def _deliver(fut: Future, result=None, exc=None) -> None:
    """Resolve a future, tolerating caller-side cancellation: a cancelled
    future must never kill the worker thread."""
    try:
        if fut.cancelled():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:
        pass  # racing cancel() between the check and the set


@dataclass
class ServeStats:
    """Counters for observability (monotonic ints, read without a lock)."""

    requests: int = 0
    images: int = 0
    batches: int = 0
    batched_images: int = 0  # images that went through the coalescer
    oversize_requests: int = 0  # ran alone via predict_proba chunking
    fill_sum: float = field(default=0.0)  # sum of per-batch fill fractions

    @property
    def mean_batch_fill(self) -> float:
        return self.fill_sum / self.batches if self.batches else 0.0


class BatchingServer:
    """Coalesces concurrent predict requests into full device batches.

    ``max_delay_ms`` is how long a worker waits to fill a batch after the
    first request arrives. ``workers`` inference threads may run batches
    concurrently (one host-side while another's kernels run); only one
    thread packs at a time, so coalescing is that of a single worker.
    """

    def __init__(self, predictor, *, max_delay_ms: float = 5.0,
                 workers: int = 2):
        self._p = predictor
        self._capacity = int(predictor.batch_size)
        self._max_delay = max_delay_ms / 1000.0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: List[Tuple[np.ndarray, Future]] = []
        self._filling = False  # single-packer gate, see _take_batch
        # Futures popped by a worker but not yet delivered, so that close()
        # can fail them when a worker hangs inside inference.
        self._inflight: List[Future] = []
        self._closed = False
        self.stats = ServeStats()
        self._workers = [
            threading.Thread(
                target=self._run, name=f"favit-serve-{i}", daemon=True
            )
            for i in range(max(1, int(workers)))
        ]
        for t in self._workers:
            t.start()

    # -- client side -----------------------------------------------------

    def submit(self, images_u8: np.ndarray) -> Future:
        """Enqueue ``[n, h, w, 3] uint8``; resolves to ``[n, C]`` probs."""
        images_u8 = np.asarray(images_u8)
        if images_u8.ndim != 4 or images_u8.shape[0] == 0:
            raise ValueError(
                f"expected non-empty [n, h, w, c] uint8, got shape "
                f"{images_u8.shape}"
            )
        fut: Future = Future()
        with self._nonempty:
            if self._closed:
                raise RuntimeError("server is closed")
            self.stats.requests += 1
            self.stats.images += len(images_u8)
            self._queue.append((images_u8, fut))
            self._nonempty.notify()
        return fut

    def predict_proba(self, images_u8: np.ndarray) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(images_u8).result()

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Drain the queue and stop the workers.

        If the workers do not finish within ``timeout`` (inference hung),
        every queued or in-flight future is failed with a RuntimeError so
        that blocked callers return."""
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()
        deadline = time.monotonic() + (timeout if timeout else 0.0)
        for t in self._workers:
            t.join(max(0.0, deadline - time.monotonic())
                   if timeout is not None else None)
        if any(t.is_alive() for t in self._workers):
            with self._nonempty:
                undelivered = [fut for _, fut in self._queue]
                undelivered += self._inflight
                self._queue.clear()
                self._inflight = []
            for fut in undelivered:
                _deliver(
                    fut,
                    exc=RuntimeError(
                        "server closed while the inference worker was "
                        "unresponsive; request abandoned"
                    ),
                )

    def __enter__(self) -> "BatchingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side -----------------------------------------------------

    def _take_batch(self) -> Optional[List[Tuple[np.ndarray, Future]]]:
        """Block for the first request, then pack whole requests until the
        device batch is full or ``max_delay`` has elapsed. Only one worker
        packs at a time (``_filling``): concurrent packers would split
        back-to-back requests into half-empty batches."""
        with self._nonempty:
            while (not self._queue or self._filling) and not self._closed:
                self._nonempty.wait()
            while self._filling:
                # Closed while another worker packs: let it finish; any
                # overflow it leaves in the queue is ours next.
                self._nonempty.wait(timeout=0.05)
            if not self._queue:
                return None  # closed and drained
            self._filling = True
            try:
                deadline = time.monotonic() + self._max_delay
                taken: List[Tuple[np.ndarray, Future]] = []
                n = 0
                hw = None  # only same-(h,w,c) requests share a concatenate
                while True:
                    i = 0
                    while i < len(self._queue):
                        req = self._queue[i][0]
                        req_n = len(req)
                        if req_n > self._capacity and not taken:
                            return [self._queue.pop(i)]  # oversize: alone
                        if n + req_n <= self._capacity and (
                            hw is None or req.shape[1:] == hw
                        ):
                            taken.append(self._queue.pop(i))
                            hw = req.shape[1:]
                            n += req_n
                        else:
                            i += 1
                    remaining = deadline - time.monotonic()
                    if n >= self._capacity or self._closed or remaining <= 0:
                        return taken
                    self._nonempty.wait(timeout=remaining)
            finally:
                self._filling = False
                self._nonempty.notify_all()

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            arrays = [a for a, _ in batch]
            futs = [fut for _, fut in batch]
            total = sum(len(a) for a in arrays)
            with self._lock:
                self._inflight.extend(futs)
            try:
                probs = self._p.predict_proba(np.concatenate(arrays))
            except Exception as e:  # propagate to every waiting caller
                for fut in futs:
                    _deliver(fut, exc=e)
                self._done_inflight(futs)
                continue
            with self._lock:
                if total > self._capacity:
                    self.stats.oversize_requests += 1
                else:
                    self.stats.batches += 1
                    self.stats.batched_images += total
                    self.stats.fill_sum += total / self._capacity
            off = 0
            for a, fut in batch:
                _deliver(fut, result=probs[off : off + len(a)])
                off += len(a)
            self._done_inflight(futs)

    def _done_inflight(self, futs) -> None:
        with self._lock:
            for f in futs:
                try:
                    self._inflight.remove(f)
                except ValueError:
                    pass  # close() already drained the list


class HTTPFrontend:
    """Localhost HTTP endpoint over a :class:`BatchingServer`; bodies are
    numpy ``.npy`` both ways."""

    def __init__(self, server: BatchingServer, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 120.0):
        import http.server
        import io
        import json

        srv = server
        timeout_s = request_timeout_s

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet; stats carry the counters
                pass

            def _reply(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, b"ok", "text/plain")
                elif self.path == "/stats":
                    s = srv.stats
                    payload = json.dumps(dict(
                        requests=s.requests, images=s.images,
                        batches=s.batches, batched_images=s.batched_images,
                        oversize_requests=s.oversize_requests,
                        mean_batch_fill=round(s.mean_batch_fill, 4),
                    )).encode()
                    self._reply(200, payload, "application/json")
                else:
                    self._reply(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/predict":
                    self._reply(404, b"not found", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    arr = np.load(io.BytesIO(self.rfile.read(n)),
                                  allow_pickle=False)
                    probs = srv.submit(arr).result(timeout=timeout_s)
                except ValueError as e:
                    self._reply(400, str(e).encode(), "text/plain")
                    return
                except TimeoutError as e:
                    self._reply(
                        504, f"inference timed out: {e}".encode(),
                        "text/plain",
                    )
                    return
                except RuntimeError as e:
                    # A server fault, not a client error: a closed server or
                    # a device failure surfaced through the future. 503 lets
                    # clients retry and balancers mark the server unhealthy.
                    self._reply(
                        503, f"{type(e).__name__}: {e}".encode(),
                        "text/plain",
                    )
                    return
                except Exception as e:  # anything else: 500, never a
                    # dropped connection
                    self._reply(
                        500, f"{type(e).__name__}: {e}".encode(),
                        "text/plain",
                    )
                    return
                buf = io.BytesIO()
                np.save(buf, probs)
                self._reply(200, buf.getvalue(), "application/x-npy")

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="favit-http", daemon=True
        )

    def start(self) -> "HTTPFrontend":
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread.is_alive():
            # shutdown() waits on an event only serve_forever() sets:
            # calling it before start() would deadlock.
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    def __enter__(self) -> "HTTPFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _build_model(args):
    from focused_attention_vit_tpu_torch import models

    kw = dict(
        img_size=args.img_size, patch_size=args.patch_size,
        num_classes=args.num_classes, embed_dim=args.embed_dim,
        depth=args.depth, num_heads=args.num_heads,
    )
    if args.model == "vit":
        return models.VisionTransformer(**kw)
    return models.VisionTransformerMHLA(window_size=args.window_size, **kw)


def _parser():
    import argparse

    class Parser(argparse.ArgumentParser):
        """Exactly one weights source; an artifact is served as it is
        (JAX ``serve.py``'s rules, with ``--weights`` beside
        ``--checkpoint_dir``)."""

        def parse_args(self, args=None, namespace=None):
            a = super().parse_args(args, namespace)
            if a.from_export:
                for flag in ("export_artifact", "checkpoint_dir", "weights"):
                    if getattr(a, flag):
                        self.error(
                            f"--from_export and --{flag} are exclusive: the "
                            f"artifact carries its own program and weights")
            elif not (a.weights or a.checkpoint_dir):
                self.error("one of --weights, --checkpoint_dir or "
                           "--from_export is required")
            elif a.weights and a.checkpoint_dir:
                self.error("--weights and --checkpoint_dir are exclusive")
            return a

    p = Parser(description="favit serving front end (PyTorch)")
    p.add_argument("--weights", type=str,
                   help=".pt/.pth state dict (reference torch layout) or "
                        ".npz of /-joined JAX param paths")
    p.add_argument("--checkpoint_dir", type=str,
                   help="training checkpoint directory: its "
                        "params_latest.pt, or a JAX run's "
                        "params_latest.msgpack")
    p.add_argument("--from_export", type=str, default=None, metavar="DIR",
                   help="serve a torch.export artifact directory "
                        "(export.save_serving_artifact): no model class or "
                        "weights needed; the model flags are ignored")
    p.add_argument("--export_artifact", type=str, default=None,
                   metavar="DIR",
                   help="instead of serving: write the serving program and "
                        "its weights to DIR, print its path and exit")
    p.add_argument("--model", choices=["vit", "vit_mhla"],
                   default="vit_mhla",
                   help="vit: dense attention; vit_mhla: windowed latent "
                        "attention")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--embed_dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--window_size", type=int, default=7)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batch_size", type=int, default=64,
                   help="device batch (every forward pass has this shape)")
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--workers", type=int, default=2,
                   help="inference worker threads (coalescing stays "
                        "single-packer)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on")
    p.add_argument("--num_devices", type=int, default=None,
                   help="serve on a mesh of N ranks (None or <= 0: every "
                        "device); the command starts them unless RANK is "
                        "set")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size of the serving mesh")
    return p


def _world_size(args) -> int:
    """The ranks of the serving mesh, JAX's rule: a mesh when
    ``--num_devices`` or ``--tp > 1`` asks for one, over every device for
    None or <= 0 (one on the CPU); 1 (no mesh) for one device at tp 1 and
    for ``--from_export``."""
    import torch

    if args.from_export or not (args.num_devices or args.tp > 1):
        return 1
    n = args.num_devices
    if n is None or n <= 0:
        n = (1 if torch.device(args.device).type == "cpu"
             else torch.cuda.device_count())
    return n if (n > 1 or args.tp > 1) else 1


def setup(argv=None):
    """Parse serving flags and build the predictor: with ``--from_export``
    the artifact's :class:`~.export.ExportedPredictor`, else a
    :class:`~.infer.Predictor` from the weights, warmed up unless
    ``--export_artifact`` asks for an artifact instead. Returns
    ``(args, predictor)``."""
    import torch

    from focused_attention_vit_tpu_torch.infer import Predictor

    args = _parser().parse_args(argv)
    if args.from_export:
        from focused_attention_vit_tpu_torch.export import (
            load_serving_artifact,
        )

        predictor = load_serving_artifact(args.from_export)
        predictor.warmup()
        return args, predictor
    device = args.device
    mesh = None
    world = _world_size(args)
    if world > 1 or args.tp > 1:
        import torch.distributed as dist

        from focused_attention_vit_tpu_torch.parallel import make_mesh

        if world % args.tp:
            raise ValueError(f"tp={args.tp} * sp=1 * pp=1 must divide device "
                             f"count {world}")
        mesh = make_mesh(world, tp=args.tp)
        if torch.device(device).type == "cuda":
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
            torch.cuda.set_device(device)
    kw = dict(img_size=args.img_size, device=device, mesh=mesh,
              batch_size=args.batch_size,
              compute_dtype=(torch.bfloat16
                             if args.compute_dtype == "bfloat16"
                             else torch.float32))
    if args.checkpoint_dir:
        predictor = Predictor.from_checkpoint(
            _build_model(args), args.checkpoint_dir, **kw)
    else:
        predictor = Predictor.from_weights(_build_model(args), args.weights,
                                           **kw)
    if not args.export_artifact:
        predictor.warmup()
    return args, predictor


def main(argv=None) -> None:
    """``python -m focused_attention_vit_tpu_torch.serve --weights ...``
    (or ``--checkpoint_dir ...``, or ``--from_export DIR``): serve HTTP
    until interrupted; with ``--export_artifact DIR`` write the serving
    artifact instead and exit. With a mesh (``--num_devices``, ``--tp``)
    and no ``RANK`` in the environment, start the ranks and wait for
    them."""
    import contextlib

    import torch
    import torch.distributed as dist

    from focused_attention_vit_tpu_torch.parallel import launch, multihost

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    world = _world_size(args)
    if world > 1 and "RANK" not in os.environ:
        launch.launch_serve(argv, world, "gloo" if cpu else "nccl")
        return
    own_group = "RANK" in os.environ and not dist.is_initialized()
    if own_group:  # torchrun
        multihost.initialize(backend="gloo" if cpu else "nccl")
    try:
        if dist.is_initialized() and dist.get_rank() != 0:
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                _serve(argv)
        else:
            _serve(argv)
    finally:
        if own_group:
            dist.destroy_process_group()


def _serve(argv) -> None:
    """Build the predictor and serve it, or write its artifact; on a mesh
    the ranks other than 0 follow rank 0's batches."""
    import torch.distributed as dist

    args, predictor = setup(argv)
    if args.export_artifact:
        from focused_attention_vit_tpu_torch.export import (
            save_serving_artifact,
        )

        out = save_serving_artifact(predictor, args.export_artifact)
        print(f"serving artifact written to {out}", flush=True)
        return
    if getattr(predictor, "mesh", None) is not None and dist.get_rank():
        predictor.follow()
        return
    try:
        with BatchingServer(predictor, max_delay_ms=args.max_delay_ms,
                            workers=args.workers) as srv:
            with HTTPFrontend(srv, host=args.host, port=args.port) as fe:
                mesh = getattr(predictor, "mesh", None)
                where = (f"{predictor.device}" if mesh is None else
                         f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                         f"mesh")
                print(f"serving on http://{fe.host}:{fe.port} "
                      f"(POST /predict, GET /stats, GET /healthz; "
                      f"batch {predictor.batch_size}, {where})", flush=True)
                try:
                    while True:
                        time.sleep(3600)
                except KeyboardInterrupt:
                    print("shutting down", flush=True)
    finally:
        if hasattr(predictor, "close"):
            predictor.close()


if __name__ == "__main__":
    main()
