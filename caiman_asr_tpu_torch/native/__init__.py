"""The port's host-side C++, built on first use and loaded with ctypes.

The port's own copies of the JAX package's ``native/src/serialize.cpp``,
``staging.cpp`` and ``flac_decoder.cpp``
(``caiman_asr_tpu/native/__init__.py:57-393``):

- ``ResponseSerializer``: the greedy and beam ticks' responses as
  wire-ready JSON from the packed int32 tick output, with each lane's frame
  index and, for the beam, its commit state (committed horizon and the
  best hypothesis' token history);
- ``AudioStaging``: per-lane int16 buffers and the fill of the staging
  matrix the tick uploads;
- ``flac_decode`` / ``flac_decode_file``: FLAC to int32 samples (the audio
  reader's FLAC path);
- ``levenshtein``: the edit distance of two int sequences (WER).

The first use compiles ``src/*.cpp`` with ``g++`` into
``build/native/libcaiman_serving.so`` at the root of the checkout (listed in
``.gitignore``), rebuilding when a source is newer than the library. The
build goes to a temporary file renamed into place, so processes that build
at once never load a half-written library. A build that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

SRCS = [Path(__file__).parent / "src" / name
        for name in ("serialize.cpp", "staging.cpp", "flac_decoder.cpp")]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB = BUILD_DIR / "libcaiman_serving.so"


class NativeBuildError(RuntimeError):
    pass


def build(lib: Path = LIB) -> Path:
    """Compile the sources into ``lib`` unless it is newer than all of them."""
    if lib.exists() and all(lib.stat().st_mtime >= s.stat().st_mtime for s in SRCS):
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", *map(str, SRCS), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        os.unlink(tmp)
        raise NativeBuildError(f"building {lib.name} failed: {getattr(e, 'stderr', e)}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp, i, lng = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    signatures = {
        "ser_init": ([i, i, i, ctypes.c_double, i], vp),
        "ser_free": ([vp], None),
        "ser_set_piece": ([vp, i, ctypes.c_char_p, i], None),
        "ser_reset_lane": ([vp, i], None),
        "ser_greedy_tick": ([vp, i32p, lng, i, u8p, i, ctypes.c_char_p, lng, i32p, lng,
                             ctypes.POINTER(lng)], lng),
        "ser_beam_tick": ([vp, i32p, lng, u8p, i, ctypes.c_char_p, lng,
                           ctypes.POINTER(ctypes.c_int64), i32p, lng, ctypes.POINTER(lng)], lng),
        "ser_set_frame_idx": ([vp, i, ctypes.c_int64], None),
        "ser_lane_committed": ([vp, i], ctypes.c_int64),
        "ser_lane_frame_idx": ([vp, i], ctypes.c_int64),
        "stg_init": ([i, i, i], vp),
        "stg_free": ([vp], None),
        "stg_reset_lane": ([vp, i], None),
        "stg_push": ([vp, i, vp, lng], None),
        "stg_push_i16": ([vp, i, vp, lng], None),
        "stg_push_rows_i16": ([vp, vp, lng, vp, i, lng], None),
        "stg_push_rows_f32": ([vp, vp, lng, vp, i, lng], None),
        "stg_buffered": ([vp, i], lng),
        "stg_tick": ([vp, ctypes.POINTER(ctypes.c_int16), lng, u8p, u8p, i, u8p, u8p], None),
        "flac_decode": ([ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(i32p),
                         ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(i),
                         ctypes.POINTER(i), ctypes.POINTER(i), ctypes.c_char_p], i),
        "caiman_free": ([vp], None),
        "levenshtein_i64": ([ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_int64), ctypes.c_int64], ctypes.c_int64),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def flac_decode(data: bytes) -> Tuple[np.ndarray, int, int, bytes]:
    """Decode a FLAC byte stream. Returns (samples [n, channels] int32,
    sample rate, bits per sample, the STREAMINFO MD5). Raises ValueError on
    malformed input."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_int32)()
    n, ch, sr, bps = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    md5 = ctypes.create_string_buffer(16)
    rc = lib.flac_decode(data, len(data), ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch),
                         ctypes.byref(sr), ctypes.byref(bps), md5)
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc})")
    try:
        samples = np.ctypeslib.as_array(out, shape=(n.value * ch.value,)).reshape(
            n.value, ch.value).copy()
    finally:
        lib.caiman_free(out)
    return samples, sr.value, bps.value, bytes(md5.raw)


def flac_decode_file(path) -> Tuple[np.ndarray, int, int, bytes]:
    return flac_decode(Path(path).read_bytes())


def levenshtein(a, b) -> int:
    """Edit distance between two int sequences."""
    lib = _lib()
    aa = np.ascontiguousarray(a, dtype=np.int64)
    bb = np.ascontiguousarray(b, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    return int(lib.levenshtein_i64(aa.ctypes.data_as(i64p), len(aa),
                                   bb.ctypes.data_as(i64p), len(bb)))


class _Handle:
    """A C state freed on ``close()`` or garbage collection, whichever comes
    first; every call goes through ``_live()``, so a closed handle raises
    instead of handing C a NULL pointer."""

    def __init__(self, h, free):
        import weakref

        if not h:
            raise ValueError(f"{type(self).__name__}: the native state was refused")
        self._h = h
        self._finalize = weakref.finalize(self, free, h)

    def close(self):
        self._finalize()
        self._h = None

    def _live(self):
        if self._h is None:
            raise ValueError(f"{type(self).__name__} used after close()")
        return self._h


class ResponseSerializer(_Handle):
    """Responses from the packed tick output (``src/serialize.cpp``): per
    lane, the JSON of ``{start, end, is_provisional, alternatives}``, and its
    frame index (ticks consumed). Greedy: the tokens a lane emitted this
    tick. Beam (``beam_width`` W, a window of ``beam_win`` tokens a
    hypothesis): the finals where the live hypotheses' common prefix grew
    (or the history of the best one slid out of the window) and the best
    hypothesis' uncommitted tail as a partial; ``beam_width`` is at most
    64."""

    def __init__(self, max_lanes: int, frame_seconds: float, pieces, beam_width: int = 1,
                 beam_win: int = 1):
        self._lib = _lib()
        super().__init__(self._lib.ser_init(max_lanes, beam_width, beam_win,
                                            float(frame_seconds), len(pieces)),
                         self._lib.ser_free)
        for n, p in enumerate(pieces):
            b = p.encode("utf-8") if isinstance(p, str) else bytes(p)
            self._lib.ser_set_piece(self._h, n, b, len(b))
        self._buf = ctypes.create_string_buffer(4 << 20)
        # (lane, payload offset, payload length) a record; a lane emits at
        # most 3 a tick (beam: a slide-out final, a final, a partial)
        self._idx = np.zeros((3 * max_lanes + 8, 3), np.int32)
        self._nrec = ctypes.c_long(0)
        self._dev_len = np.zeros(max_lanes, np.int64)

    def reset_lane(self, lane: int):
        self._lib.ser_reset_lane(self._live(), lane)

    def frame_idx(self, lane: int) -> int:
        return int(self._lib.ser_lane_frame_idx(self._live(), lane))

    def committed(self, lane: int) -> int:
        """Beam tokens the lane has shipped as finals (buffer positions)."""
        return int(self._lib.ser_lane_committed(self._live(), lane))

    def set_frame_idx(self, lane: int, v: int):
        self._lib.ser_set_frame_idx(self._live(), lane, int(v))

    def greedy_tick_raw(self, packed: np.ndarray, adv: np.ndarray):
        """packed: int32 [B, cap + 1]; adv: bool [B]. Returns (raw bytes,
        idx int32 [n, 3] of (lane, offset, length)): ``raw[off:off+len]`` is
        one lane's JSON. idx views a buffer the next call overwrites."""
        h = self._live()
        packed = np.ascontiguousarray(packed, np.int32)
        advu = np.ascontiguousarray(adv, np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        while True:
            n = self._lib.ser_greedy_tick(
                h, packed.ctypes.data_as(i32p), packed.shape[1], packed.shape[1] - 1,
                advu.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), packed.shape[0],
                self._buf, len(self._buf), self._idx.ctypes.data_as(i32p),
                self._idx.shape[0], ctypes.byref(self._nrec))
            if n >= 0:
                return ctypes.string_at(self._buf, n), self._idx[: self._nrec.value]
            self._buf = ctypes.create_string_buffer(len(self._buf) * 2)

    def greedy_tick(self, packed: np.ndarray, adv: np.ndarray):
        """The same as ``{lane: [json_str]}``."""
        return _to_dict(*self.greedy_tick_raw(packed, adv))

    def beam_tick_raw(self, packed: np.ndarray, adv: np.ndarray):
        """packed: int32 [B, W*win + W + 2 + W], the layout ``[tokens (W x
        win) | lens (W) | base | rebase echo | scores (W, fp32 bits)]``;
        adv: bool [B]. Returns (raw bytes, idx int32 [n, 3], dev_len int64
        [B]): dev_len is each advanced lane's longest hypothesis (its other
        entries keep their last value). idx and dev_len view buffers the
        next call overwrites."""
        h = self._live()
        packed = np.ascontiguousarray(packed, np.int32)
        advu = np.ascontiguousarray(adv, np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        while True:
            n = self._lib.ser_beam_tick(
                h, packed.ctypes.data_as(i32p), packed.shape[1],
                advu.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), packed.shape[0],
                self._buf, len(self._buf),
                self._dev_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._idx.ctypes.data_as(i32p), self._idx.shape[0], ctypes.byref(self._nrec))
            if n >= 0:
                return (ctypes.string_at(self._buf, n), self._idx[: self._nrec.value],
                        self._dev_len)
            self._buf = ctypes.create_string_buffer(len(self._buf) * 2)

    def beam_tick(self, packed: np.ndarray, adv: np.ndarray):
        """The same as ``({lane: [json_str]}, dev_len)``."""
        raw, idx, dev_len = self.beam_tick_raw(packed, adv)
        return _to_dict(raw, idx), dev_len


def _to_dict(raw: bytes, idx: np.ndarray):
    out = {}
    for lane, off, ln in idx.tolist():
        out.setdefault(lane, []).append(raw[off:off + ln].decode("utf-8"))
    return out


class AudioStaging(_Handle):
    """Per-lane int16 audio buffers and the staging fill (``src/staging.cpp``):
    one ``tick`` pops ``hop`` samples of each ready lane into its row of the
    [B, carry_len + hop] staging matrix. Float pushes are rounded to int16."""

    def __init__(self, max_lanes: int, carry_len: int, hop: int):
        self._lib = _lib()
        super().__init__(self._lib.stg_init(max_lanes, carry_len, hop), self._lib.stg_free)
        self._i16p = ctypes.POINTER(ctypes.c_int16)
        self._u8p = ctypes.POINTER(ctypes.c_uint8)
        self._adv = np.zeros(max_lanes, np.uint8)
        self._fin = np.zeros(max_lanes, np.uint8)

    def reset_lane(self, lane: int):
        self._lib.stg_reset_lane(self._live(), lane)

    def push(self, lane: int, samples: np.ndarray):
        x = samples
        if isinstance(x, np.ndarray) and x.dtype == np.int16:
            x = np.ascontiguousarray(x)
            self._lib.stg_push_i16(self._live(), lane, x.ctypes.data, x.size)
            return
        x = np.ascontiguousarray(x, np.float32)
        self._lib.stg_push(self._live(), lane, x.ctypes.data, x.size)

    def push_rows(self, block: np.ndarray, lanes=None):
        """Row i of ``block`` ([m, n] int16 or float32) to lane ``lanes[i]``
        (lane i when lanes is None), in one call."""
        lanes_ptr = 0
        if lanes is not None:
            lanes = np.ascontiguousarray(lanes, np.int32)
            lanes_ptr = lanes.ctypes.data
        if block.dtype == np.int16:
            block = np.ascontiguousarray(block)
            fn = self._lib.stg_push_rows_i16
        else:
            block = np.ascontiguousarray(block, np.float32)
            fn = self._lib.stg_push_rows_f32
        fn(self._live(), block.ctypes.data, block.shape[1], lanes_ptr, block.shape[0],
           block.shape[1])

    def buffered(self, lane: int) -> int:
        return int(self._lib.stg_buffered(self._live(), lane))

    def tick(self, staging: np.ndarray, active: np.ndarray, closed: np.ndarray):
        """staging: int16 [B, carry_len + hop], filled in place; active,
        closed: uint8 [B]. Returns (advanced, finishing), bool [B]."""
        if staging.dtype != np.int16 or not staging.flags.c_contiguous:
            raise ValueError("staging must be a C-contiguous int16 matrix")
        self._lib.stg_tick(
            self._live(), staging.ctypes.data_as(self._i16p), staging.shape[1],
            np.ascontiguousarray(active, np.uint8).ctypes.data_as(self._u8p),
            np.ascontiguousarray(closed, np.uint8).ctypes.data_as(self._u8p),
            staging.shape[0], self._adv.ctypes.data_as(self._u8p),
            self._fin.ctypes.data_as(self._u8p))
        return self._adv.astype(bool), self._fin.astype(bool)
