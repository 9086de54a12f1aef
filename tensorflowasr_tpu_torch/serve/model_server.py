"""Model server: the Unix/TCP socket front of the port's engines.

Counterpart of ``tensorflowasr_tpu/serve/model_server.py``, with the same
wire format byte for byte: the C++ serving host (``cpp/serving``:
``asr_client``, ``asr_stream``) does wav IO, tokens, the VAD state machine
and greedy CTC itself, and calls this server for the tensor ops that run on
the card:

  op "vad"        f32 [1, N, frame]        -> f32 [N]      voice logits
  op "encode"     f32 [1, chunk_samples]   -> f32 [T', d]  encoder output
  op "ctc_logits" f32 [1, T, d]            -> f32 [T, V]   phone logits
  op "translate"  i32 [1, U], f32 [1, T, d]-> f32 [U, Vc]  char logits
  op "info"                                -> i32 [3]

and, with ``serve/multi_session.py::build_stream_ops``, the chunk-streaming
ops ``stream_info/open/feed/result/close``.

Wire protocol (little endian):
  request  = u32 op_len | op utf8 | u32 n_tensors | tensor*
  tensor   = u8 dtype (0=f32, 1=i32) | u32 ndim | u32 dims[ndim] | payload
  response = u32 status (0 ok) | u32 n_tensors | tensor*   (status!=0:
             one i32[0] tensor and a trailing u32 msg_len + utf8 message)
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_DTYPES = {0: np.float32, 1: np.int32}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1}


def _read_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed")
        buf += part
    return buf


def read_tensor(conn: socket.socket) -> np.ndarray:
    dtype_code = struct.unpack("<B", _read_exact(conn, 1))[0]
    ndim = struct.unpack("<I", _read_exact(conn, 4))[0]
    dims = struct.unpack(f"<{ndim}I", _read_exact(conn, 4 * ndim))
    dtype = _DTYPES[dtype_code]
    count = int(np.prod(dims)) if dims else 1
    data = _read_exact(conn, count * dtype().itemsize)
    return np.frombuffer(data, dtype=dtype).reshape(dims)


def encode_tensor(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DTYPE_CODES:
        # ops may return int64 / float64: the wire has 32-bit types only
        arr = arr.astype(np.int32 if np.issubdtype(arr.dtype, np.integer)
                         else np.float32)
    code = _DTYPE_CODES[arr.dtype]
    return (struct.pack("<B", code) + struct.pack("<I", arr.ndim)
            + struct.pack(f"<{arr.ndim}I", *arr.shape) + arr.tobytes())


def write_tensor(conn: socket.socket, arr: np.ndarray) -> None:
    conn.sendall(encode_tensor(np.asarray(arr)))


class ModelServer:
    """Serves named tensor ops over a Unix (or TCP) socket.

    Each connection has its own thread. Ops run on that thread with
    ``inline_exec=True``; otherwise they are queued to the thread that calls
    :meth:`run_worker_loop` (the CLI's main thread), so that one thread does
    the card's work for them. ``inline_ops`` run on the connection thread
    either way: the stream feed blocks until the batching ticker has taken
    its chunk, and on the single worker thread that wait would serialize
    every client.
    """

    def __init__(self, ops: Dict[str, Callable[..., np.ndarray]],
                 unix_path: Optional[str] = None,
                 tcp_port: Optional[int] = None,
                 inline_exec: bool = True,
                 inline_ops: Optional[set] = None):
        self.ops = ops
        self.unix_path = unix_path
        self.tcp_port = tcp_port
        self.inline_exec = inline_exec
        self.inline_ops = inline_ops or set()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work: "queue.Queue" = queue.Queue()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self.unix_path:
            if os.path.exists(self.unix_path):
                os.unlink(self.unix_path)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(self.unix_path)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind(("127.0.0.1", self.tcp_port or 0))
            self.tcp_port = self._sock.getsockname()[1]
        self._sock.listen(4)
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        logger.info("model server listening on %s",
                    self.unix_path or f"127.0.0.1:{self.tcp_port}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._sock is not None:
            self._sock.close()
        if self.unix_path and os.path.exists(self.unix_path):
            os.unlink(self.unix_path)

    def run_worker_loop(self) -> None:
        """Execute queued ops on the calling thread until :meth:`stop`."""
        while not self._stop.is_set():
            try:
                fn, args, done = self._work.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                done["result"] = fn(*args)
            except Exception as e:  # noqa: BLE001 - forwarded to client
                done["error"] = e
            done["event"].set()

    def _execute(self, fn, args):
        if self.inline_exec:
            return fn(*args)
        done = {"event": threading.Event()}
        self._work.put((fn, args, done))
        done["event"].wait()
        if "error" in done:
            raise done["error"]
        return done["result"]

    # -- serving ------------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(60)
            while not self._stop.is_set():
                try:
                    op_len = struct.unpack("<I", _read_exact(conn, 4))[0]
                except (ConnectionError, socket.timeout):
                    return
                op = _read_exact(conn, op_len).decode("utf-8")
                n = struct.unpack("<I", _read_exact(conn, 4))[0]
                tensors = [read_tensor(conn) for _ in range(n)]
                try:
                    fn = self.ops[op]
                    if op in self.inline_ops:
                        out = fn(*tensors)
                    else:
                        out = self._execute(fn, tensors)
                    if isinstance(out, np.ndarray):
                        out = [out]
                    # serialize fully before sending: a failure halfway
                    # through a response would desynchronize the wire
                    payload = b"".join(encode_tensor(np.asarray(t))
                                       for t in out)
                    conn.sendall(struct.pack("<II", 0, len(out)) + payload)
                except Exception as e:  # noqa: BLE001 - report to client
                    logger.exception("op %s failed", op)
                    msg = str(e).encode("utf-8")[:1000]
                    conn.sendall(
                        struct.pack("<II", 1, 1)
                        + encode_tensor(np.zeros((0,), np.int32))
                        + struct.pack("<I", len(msg)) + msg)
        finally:
            conn.close()


def build_asr_ops(asr_engine, vad_engine=None) -> Dict[str, Callable]:
    """The op table over ``serve/engines.py::ASREngine``. Each op runs under
    ``torch.no_grad`` on whatever thread executes it (grad mode is
    thread-local). ``vad`` is ``vad_engine.inference`` (a
    ``serve/engines.py::VADEngine``) or, without one, the energy gate of
    ``serve/vad_machine.py::SilenceDetector``."""
    from tensorflowasr_tpu_torch.serve.vad_machine import SilenceDetector

    model = asr_engine.model
    dev = asr_engine.device

    def _enc(enc: np.ndarray) -> torch.Tensor:
        """[T, d] or [1, T, d] -> a [1, T, d] tensor on the card (a copy:
        arrays read off the wire are read-only)."""
        enc = np.asarray(enc, np.float32).reshape(1, -1, enc.shape[-1])
        return torch.tensor(enc, device=dev)

    def encode(wav: np.ndarray) -> np.ndarray:
        return asr_engine.extract_feature(wav.reshape(-1))

    @torch.no_grad()
    def ctc_logits(enc: np.ndarray) -> np.ndarray:
        return model.ctc_logits(_enc(enc))[0].cpu().numpy()

    @torch.no_grad()
    def translate(ids: np.ndarray, enc: np.ndarray) -> np.ndarray:
        ids = torch.tensor(np.asarray(ids, np.int32).reshape(1, -1),
                           device=dev)
        return model.translate(ids, _enc(enc))[0].cpu().numpy()

    def info() -> np.ndarray:
        """[chunk_samples, sample_rate, dmodel]: clients size their encode
        chunks from it."""
        return np.asarray([asr_engine.chunk_samples, asr_engine.sample_rate,
                           model.cfg.dmodel], np.int32)

    ops = {"encode": encode, "ctc_logits": ctc_logits,
           "translate": translate, "info": info}
    if vad_engine is not None:
        ops["vad"] = vad_engine.inference
        return ops
    sd = SilenceDetector()

    def energy_vad(frames: np.ndarray) -> np.ndarray:
        """A positive logit for the frames whose sound pressure level clears
        the detector's threshold."""
        f = frames.reshape(-1, frames.shape[-1])
        spl = np.asarray([sd.sound_pressure_level(row) for row in f])
        return (spl - sd.threshold).astype(np.float32)

    ops["vad"] = energy_vad
    return ops


class ModelClient:
    """The Python client of the wire protocol (what the C++ client does)."""

    def __init__(self, unix_path: Optional[str] = None,
                 tcp_port: Optional[int] = None):
        if unix_path:
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.connect(unix_path)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.connect(("127.0.0.1", tcp_port))

    def call(self, op: str, *tensors: np.ndarray) -> List[np.ndarray]:
        enc = op.encode("utf-8")
        self.sock.sendall(struct.pack("<I", len(enc)) + enc)
        self.sock.sendall(struct.pack("<I", len(tensors)))
        for t in tensors:
            write_tensor(self.sock, np.asarray(t))
        status = struct.unpack("<I", _read_exact(self.sock, 4))[0]
        n = struct.unpack("<I", _read_exact(self.sock, 4))[0]
        out = [read_tensor(self.sock) for _ in range(n)]
        if status != 0:
            msg_len = struct.unpack("<I", _read_exact(self.sock, 4))[0]
            msg = _read_exact(self.sock, msg_len).decode("utf-8")
            raise RuntimeError(f"server error for op {op}: {msg}")
        return out

    def close(self):
        self.sock.close()
