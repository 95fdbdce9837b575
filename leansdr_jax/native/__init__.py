"""Native (C++) runtime components, loaded via ctypes.

The reference implements its whole runtime in C++; the device compute path
here is JAX/Pallas, but the host-side runtime around it — the byte-domain
RX backend (framing/deinterleave/RS/derandomize, reference dvb.h:712-1163)
— is also provided natively. `byte_backend.cc` is compiled on demand with
g++ into a gitignored build dir keyed by source hash; if no compiler is
available the Python implementation (pipelines/multi_rx._ByteBackend) is
used instead — `get_lib()` returns None in that case.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "byte_backend.cc"
_BUILD = _DIR / "_build"

_lib = None
_lib_tried = False


def build_lib(verbose: bool = False) -> Path | None:
    """Compile byte_backend.cc if needed; returns the .so path or None."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = _BUILD / f"byte_backend_{tag}.so"
    if so.exists():
        return so
    _BUILD.mkdir(exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"     # unique: concurrent builders race
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           str(_SRC), "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        if verbose:
            print(r.stderr)
        return None
    os.replace(tmp, so)                 # atomic publish
    return so


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("LEANSDR_NO_NATIVE"):
        return None
    so = build_lib()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.bb_create.restype = ctypes.c_void_p
    lib.bb_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bb_destroy.argtypes = [ctypes.c_void_p]
    lib.bb_feed.restype = ctypes.c_long
    lib.bb_feed.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    lib.bb_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_longlong)]
    lib.bb_save.restype = ctypes.c_long
    lib.bb_save.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.bb_restore.restype = ctypes.c_int
    lib.bb_restore.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_long]
    _lib = lib
    return _lib


TS_SIZE = 188


class NativeByteBackend:
    """Drop-in replacement for multi_rx._ByteBackend backed by the C++
    runtime: one `feed` call runs framing + deinterleave + RS decode +
    derandomize for the whole fleet."""

    def __init__(self, nchan: int, fastlock: bool, on_next_sync=None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native byte backend unavailable")
        self._lib = lib
        self.nchan = nchan
        self.on_next_sync = on_next_sync
        self._ctx = lib.bb_create(nchan, int(fastlock))
        self._counts = np.zeros(nchan, dtype=np.int64)
        self._nsync = np.zeros(nchan, dtype=np.int32)

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.bb_destroy(ctx)
            self._ctx = None

    def feed(self, bytes_by_chan) -> list:
        C = self.nchan
        offs = np.zeros(C + 1, dtype=np.int64)
        for c in range(C):
            offs[c + 1] = offs[c] + len(bytes_by_chan[c])
        total_in = int(offs[-1])
        flat = np.empty(max(total_in, 1), dtype=np.uint8)
        for c in range(C):
            if len(bytes_by_chan[c]):
                flat[offs[c]:offs[c + 1]] = bytes_by_chan[c]
        # Output cap: every input byte + backlog can yield at most
        # in/204 packets, plus slack for backlogged deinterleaver drain.
        cap = total_in // 204 + 64 * C + 16
        out = np.empty((cap, TS_SIZE), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = self._lib.bb_feed(
            self._ctx,
            flat.ctypes.data_as(u8p),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            out.ctypes.data_as(u8p),
            cap,
            self._counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            self._nsync.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if n < 0:
            raise RuntimeError("native byte backend output overflow")
        if self.on_next_sync is not None:
            for c in np.nonzero(self._nsync)[0]:
                for _ in range(int(self._nsync[c])):
                    self.on_next_sync(int(c))
        outs = []
        o = 0
        for c in range(C):
            k = int(self._counts[c])
            outs.append(out[o:o + k].copy())
            o += k
        return outs

    def _stats(self):
        C = self.nchan
        vbit = np.zeros(C, dtype=np.int64)
        verr = np.zeros(C, dtype=np.int64)
        locks = np.zeros(C, dtype=np.uint8)
        lockt = np.zeros(C, dtype=np.int64)
        llp = ctypes.POINTER(ctypes.c_longlong)
        self._lib.bb_stats(
            self._ctx,
            vbit.ctypes.data_as(llp), verr.ctypes.data_as(llp),
            locks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lockt.ctypes.data_as(llp))
        return vbit, verr, locks, lockt

    @property
    def vbitcount(self):
        return self._stats()[0]

    @property
    def verrcount(self):
        return self._stats()[1]

    @property
    def locks(self):
        return [bool(v) for v in self._stats()[2]]

    @property
    def locktimes(self):
        return self._stats()[3]

    # -- checkpoint/resume ------------------------------------------------

    def save_blob(self) -> bytes:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = self._lib.bb_save(self._ctx, ctypes.cast(None, u8p), 0)
        buf = np.empty(n, np.uint8)
        m = self._lib.bb_save(self._ctx, buf.ctypes.data_as(u8p), n)
        assert m == n
        return buf.tobytes()

    def restore_blob(self, blob: bytes):
        buf = np.frombuffer(blob, np.uint8)
        r = self._lib.bb_restore(
            self._ctx, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf))
        if r != 0:
            raise ValueError(f"native backend restore failed ({r})")
