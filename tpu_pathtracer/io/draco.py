"""Draco mesh compression codec (native C++, ctypes binding).

The reference decodes KHR_draco_mesh_compression glTF primitives with a
vendored Google WASM decoder (reference: public/static/draco/,
src/main.ts:258-260).  Ours is a from-scratch C++ implementation of the
Draco 2.2 bitstream (csrc/draco_codec.cpp) — decode *and* encode, so
`io.gltf.save_glb(..., draco=True)` emits compressed GLBs that round-trip
through `load_gltf`.

Supported subset: the sequential method (uncompressed connectivity) and the
edgebreaker method (standard CLERS traversal; the encoder applies it to
closed 2-manifold genus-0 meshes and falls back to sequential otherwise);
raw-float or quantized-integer attributes (PREDICTION_NONE), values
raw-width or rANS-entropy-coded.  Valence-coded edgebreaker streams raise
DracoError with a clear message.  See csrc/draco_codec.cpp's header for
the offline-conformance caveat.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Dict, List, Optional

import numpy as np

ATT_POSITION, ATT_NORMAL, ATT_COLOR, ATT_TEX_COORD, ATT_GENERIC = range(5)

_ATT_NAMES = {0: "POSITION", 1: "NORMAL", 2: "COLOR", 3: "TEX_COORD",
              4: "GENERIC"}


class DracoError(ValueError):
    pass


def _find_src() -> Optional[str]:
    here = os.path.dirname(__file__)
    for cand in (
        os.path.join(here, "..", "..", "csrc", "draco_codec.cpp"),
        os.path.join(here, "..", "accel", "_csrc", "draco_codec.cpp"),
    ):
        cand = os.path.abspath(cand)
        if os.path.exists(cand):
            return cand
    return None


_SRC = _find_src()
_BUILD_DIR = (os.path.join(os.path.dirname(_SRC), "build") if _SRC
              else os.path.join(os.path.dirname(__file__), "build"))
_SO = os.path.join(_BUILD_DIR, "libpathtracer_draco.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build beside the target and rename: another process may load _SO
    # while this one compiles it
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        print(f"[tpu_pathtracer] draco codec build failed:\n{proc.stderr}",
              file=sys.stderr)
        return False
    os.replace(tmp, _SO)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native codec, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PATHTRACER_NO_NATIVE"):
            return None
        try:
            if _SRC is None:
                return None
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                if not _compile():
                    return None
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

        i64, u8p, u32p, f32p, i64p = (
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        )
        lib.pt_draco_last_error.restype = ctypes.c_char_p
        lib.pt_draco_last_error.argtypes = []
        lib.pt_draco_open.restype = ctypes.c_void_p
        lib.pt_draco_open.argtypes = [u8p, i64]
        lib.pt_draco_close.restype = None
        lib.pt_draco_close.argtypes = [ctypes.c_void_p]
        lib.pt_draco_h_info.restype = i64
        lib.pt_draco_h_info.argtypes = [ctypes.c_void_p, i64p]
        lib.pt_draco_h_attr_info.restype = i64
        lib.pt_draco_h_attr_info.argtypes = [ctypes.c_void_p, i64, i64p]
        lib.pt_draco_h_indices.restype = i64
        lib.pt_draco_h_indices.argtypes = [ctypes.c_void_p, u32p]
        lib.pt_draco_h_attr_f32.restype = i64
        lib.pt_draco_h_attr_f32.argtypes = [ctypes.c_void_p, i64, f32p]
        lib.pt_draco_info.restype = i64
        lib.pt_draco_info.argtypes = [u8p, i64, i64p]
        lib.pt_draco_attr_info.restype = i64
        lib.pt_draco_attr_info.argtypes = [u8p, i64, i64, i64p]
        lib.pt_draco_indices.restype = i64
        lib.pt_draco_indices.argtypes = [u8p, i64, u32p]
        lib.pt_draco_attr_f32.restype = i64
        lib.pt_draco_attr_f32.argtypes = [u8p, i64, i64, f32p]
        lib.pt_draco_encode.restype = i64
        lib.pt_draco_encode.argtypes = [
            f32p, ctypes.c_void_p, i64, u32p, i64, i64, i64, u8p, i64,
        ]
        lib.pt_draco_encode2.restype = i64
        lib.pt_draco_encode2.argtypes = [
            f32p, ctypes.c_void_p, i64, u32p, i64, i64, i64, i64, i64,
            u8p, i64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _err(lib) -> str:
    return lib.pt_draco_last_error().decode("utf-8", "replace")


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise DracoError(
            "native Draco codec unavailable (g++ build failed or "
            "PATHTRACER_NO_NATIVE set); decode Draco assets offline, e.g. "
            "`gltf-pipeline -i model.glb -o out.glb -d`"
        )
    return lib


def decode(data: bytes) -> Dict[str, object]:
    """Decode a Draco stream.

    Returns {"indices": (F,3) int64, "attributes": [ {unique_id, att_type,
    name, components, values (N,C) float32} ... ]}.
    """
    lib = _require_lib()
    buf = np.frombuffer(data, np.uint8)
    n = np.int64(buf.size)
    # decode-to-handle: ONE stream parse; every accessor below reads the
    # cached DecodedMesh (a k-attribute mesh used to be fully re-decoded
    # 2+2k times — advisor finding, round 1)
    handle = lib.pt_draco_open(buf, n)
    if not handle:
        raise DracoError(_err(lib))
    try:
        info = np.zeros(3, np.int64)
        if lib.pt_draco_h_info(handle, info) != 0:
            raise DracoError(_err(lib))
        num_points, num_faces, num_attrs = (int(x) for x in info)

        idx = np.empty(3 * num_faces, np.uint32)
        if lib.pt_draco_h_indices(handle, idx) < 0:
            raise DracoError(_err(lib))

        attrs: List[Dict[str, object]] = []
        for j in range(num_attrs):
            ai = np.zeros(4, np.int64)
            if lib.pt_draco_h_attr_info(handle, j, ai) != 0:
                raise DracoError(_err(lib))
            unique_id, att_type, _dtype, comps = (int(x) for x in ai)
            vals = np.empty(num_points * comps, np.float32)
            if lib.pt_draco_h_attr_f32(handle, j, vals) < 0:
                raise DracoError(_err(lib))
            attrs.append({
                "unique_id": unique_id,
                "att_type": att_type,
                "name": _ATT_NAMES.get(att_type, "GENERIC"),
                "components": comps,
                "values": vals.reshape(num_points, comps),
            })
    finally:
        lib.pt_draco_close(handle)
    return {
        "num_points": num_points,
        "indices": idx.astype(np.int64).reshape(-1, 3),
        "attributes": attrs,
    }


def encode(
    positions: np.ndarray,
    indices: np.ndarray,
    normals: Optional[np.ndarray] = None,
    *,
    position_bits: int = 14,
    normal_bits: int = 10,
    method: str = "sequential",
    rans: bool = False,
) -> bytes:
    """Encode a triangle mesh to a Draco stream.

    position_bits/normal_bits: quantization bit depth (0 = lossless raw
    float32).  Attribute unique ids: POSITION=0, NORMAL=1 (used by the glTF
    KHR_draco_mesh_compression attribute map).

    method: 'sequential' or 'edgebreaker'.  The edgebreaker path (CLERS
    connectivity, csrc/draco_codec.cpp) applies to closed 2-manifold
    genus-0 meshes with every vertex referenced, silently falling back to
    sequential otherwise — byte 8 of the returned stream names the method
    actually used.  rans=True entropy-codes quantized attribute values with
    the rANS coder (requires position_bits/normal_bits > 0 to compress).
    """
    if method not in ("sequential", "edgebreaker"):
        raise DracoError(f"unknown encode method {method!r}")
    lib = _require_lib()
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(np.asarray(indices).reshape(-1, 3), np.uint32)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise DracoError("positions must be (N,3)")
    nrm = None
    nrm_ptr = None
    if normals is not None:
        nrm = np.ascontiguousarray(normals, np.float32)
        if nrm.shape != pos.shape:
            raise DracoError("normals must match positions shape")
        nrm_ptr = nrm.ctypes.data_as(ctypes.c_void_p)
    n, f = pos.shape[0], idx.shape[0]
    m = np.int64(1 if method == "edgebreaker" else 0)
    rv = np.int64(1 if rans else 0)
    cap = 64 + 12 * 4 * n + 16 * f + 256
    out = np.empty(cap, np.uint8)
    size = lib.pt_draco_encode2(
        pos, nrm_ptr, np.int64(n), idx.reshape(-1), np.int64(f),
        np.int64(position_bits), np.int64(normal_bits), m, rv, out,
        np.int64(cap),
    )
    if size < 0:
        raise DracoError(_err(lib))
    if size > cap:  # retry with exact size
        out = np.empty(int(size), np.uint8)
        size = lib.pt_draco_encode2(
            pos, nrm_ptr, np.int64(n), idx.reshape(-1), np.int64(f),
            np.int64(position_bits), np.int64(normal_bits), m, rv, out,
            np.int64(size),
        )
        if size < 0:
            raise DracoError(_err(lib))
    return bytes(out[:int(size)].tobytes())
