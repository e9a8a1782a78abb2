"""The native (C++) JPEG pipeline, the port of ``msclip_tpu/native``.

``image_pipeline.cc`` decodes JPEG bytes with libjpeg, resamples with PIL's
bicubic (or, for training, torchvision's RandomResizedCrop and a flip from
a seeded splitmix64 stream), center-crops and normalizes, one image or a
batch on an in-library thread pool; its calls release the GIL. It is built
with ``g++ -O3 -march=native`` the first time a function here needs it
(never at import) into the ignored ``msclip_torch/_build/``, and loaded
with ``ctypes``. Two link routes are tried in order:

1. ``system``: the system's ``-ljpeg`` and its headers;
2. ``pillow``: the libjpeg-62 that Pillow's wheels ship
   (``site-packages/pillow.libs/libjpeg-*.so.62*``), linked by file name
   with an rpath, compiled against the ABI-62 headers in ``include/``
   (Pillow ships the library without headers).

The library's file name hashes the source, the vendored headers, the
route with its library, the flags and the host's CPU (``-march=native``
builds for the CPU it runs on), so a build from another machine is never
loaded. :func:`build_route` names the route taken, which is logged once.
Where neither route builds, the error is logged once and every caller
decodes with PIL, sample by sample (:func:`native_available` is False and
each decode returns None), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import logging
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(NATIVE_DIR, "image_pipeline.cc")
INCLUDE_DIR = os.path.join(NATIVE_DIR, "include")
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")
ROUTES = ("system", "pillow")

_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None
_ROUTE = None


def pillow_libjpeg():
    """The libjpeg-62 that Pillow's wheel ships next to ``PIL``, or None."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    site = os.path.dirname(list(spec.submodule_search_locations)[0])
    found = sorted(glob.glob(os.path.join(site, "pillow.libs",
                                          "libjpeg-*.so.62*")))
    return found[0] if found else None


def _link_args(route: str):
    """``(compile args, link args, library)`` of ``route``; raises when the
    route has no library on this host."""
    if route == "system":
        return [], ["-ljpeg"], "-ljpeg"
    if route == "pillow":
        lib = pillow_libjpeg()
        if lib is None:
            raise FileNotFoundError(
                "no pillow.libs/libjpeg-*.so.62* beside the PIL package")
        d = os.path.dirname(lib)
        return (["-I", INCLUDE_DIR],
                [f"-L{d}", f"-l:{os.path.basename(lib)}", f"-Wl,-rpath,{d}"],
                lib)
    raise ValueError(f"unknown link route {route!r} (one of {ROUTES})")


def _host_tag() -> bytes:
    """The CPU ``-march=native`` compiles for: its model and flags."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    tag += line
                if line.startswith("flags"):
                    break
    except OSError:
        pass
    return tag.encode()


def library_path(route: str) -> str:
    """Where ``route``'s library is (or will be) built."""
    cflags, lflags, lib = _link_args(route)
    digest = hashlib.sha256(" ".join(CXX_FLAGS + tuple(cflags)
                                     + tuple(lflags)).encode())
    digest.update(route.encode() + b"\0" + lib.encode() + b"\0"
                  + _host_tag())
    headers = sorted(os.listdir(INCLUDE_DIR))
    for path in [SOURCE] + [os.path.join(INCLUDE_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libimage_pipeline-{route}-{digest.hexdigest()[:16]}"
                        ".so")


def _build(route: str | None = None):
    """Compile the pipeline unless its library exists: through ``route``,
    or the first of :data:`ROUTES` that builds. Returns ``(path,
    route)``; raises with every route's error when none builds."""
    errors = []
    for r in (route,) if route else ROUTES:
        try:
            out = library_path(r)
            if os.path.exists(out):
                return out, r
            cflags, lflags, _ = _link_args(r)
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = ["g++", *CXX_FLAGS, *cflags, SOURCE, "-o", tmp,
                       *lflags]
                p = subprocess.run(cmd, capture_output=True, text=True)
                if p.returncode != 0:
                    raise RuntimeError(p.stderr[-2000:])
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return out, r
        except Exception as e:  # this route failed: try the next
            errors.append(f"{r}: {type(e).__name__}: {e}")
    raise RuntimeError("the native image pipeline did not build: "
                       + " | ".join(errors))


def bind(path: str):
    """``ctypes.CDLL(path)`` with the pipeline's signatures."""
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    c_int, c_size, c_double = ctypes.c_int, ctypes.c_size_t, ctypes.c_double
    for name, args in (
            ("ip_decode_eval", [u8p, c_size, c_int, f32p, f32p, f32p,
                                c_int]),
            ("ip_decode_eval_u8", [u8p, c_size, c_int, u8p, c_int]),
            ("ip_decode_train", [u8p, c_size, c_int, c_double, c_double,
                                 c_double, c_double, c_double,
                                 ctypes.c_uint64, f32p, f32p, f32p, c_int]),
            ("ip_decode_eval_batch", [u8p, u64p, c_int, c_int, f32p, f32p,
                                      c_int, f32p, i32p, c_int]),
            ("ip_decode_eval_batch_u8", [u8p, u64p, c_int, c_int, c_int,
                                         u8p, i32p, c_int])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, c_int
    return lib


def _load():
    global _LIB, _LIB_ERR, _ROUTE
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            path, route = _build()
            _LIB, _ROUTE = bind(path), route
            logging.info(f"=> native image pipeline: {build_route()} "
                         f"({path})")
        except Exception as e:  # no compiler / libjpeg: PIL fallback
            _LIB_ERR = e
            logging.warning(f"=> native image pipeline unavailable, PIL "
                            f"decodes instead: {e}")
    return _LIB


def native_available() -> bool:
    return _load() is not None


def build_error():
    _load()
    return _LIB_ERR


def build_route():
    """``"<route>: <library>"`` of the loaded pipeline, or None."""
    _load()
    if _ROUTE is None:
        return None
    return f"{_ROUTE}: {_link_args(_ROUTE)[2]}"


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _fvec(v):
    return _ptr(np.ascontiguousarray(v, np.float32), ctypes.c_float)


_JPEG_MAGIC = b"\xff\xd8"


def is_jpeg(data: bytes) -> bool:
    return data[:2] == _JPEG_MAGIC


def decode_eval(data: bytes, size: int, mean, std, dct_scale: bool = False):
    """JPEG bytes -> float32 ``[size, size, 3]``: short-side bicubic resize,
    center crop, normalize; None where the native path cannot decode
    (the caller falls back to PIL). ``dct_scale``: decode at the smallest
    IDCT scale n/8 whose short side still covers ``size`` (3-4x cheaper on
    large photos; PIL-draft-like pixels, not the full decode's)."""
    lib = _load()
    if lib is None or not is_jpeg(data):
        return None
    out = np.empty((size, size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    buf = np.frombuffer(data, np.uint8)
    rc = lib.ip_decode_eval(_ptr(buf, ctypes.c_uint8), len(data), size,
                            _fvec(mean), _fvec(std),
                            _ptr(out, ctypes.c_float), int(bool(dct_scale)))
    return out if rc == 0 else None


def decode_eval_u8(data: bytes, size: int, dct_scale: bool = False):
    """JPEG bytes -> uint8 ``[size, size, 3]`` resize + center crop; the
    normalize runs on the batch's device
    (``data/transforms.normalize_uint8``), a 4x smaller host-to-device
    payload. None where the native path cannot decode."""
    lib = _load()
    if lib is None or not is_jpeg(data):
        return None
    out = np.empty((size, size, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    rc = lib.ip_decode_eval_u8(_ptr(buf, ctypes.c_uint8), len(data), size,
                               _ptr(out, ctypes.c_uint8),
                               int(bool(dct_scale)))
    return out if rc == 0 else None


def decode_train(data: bytes, size: int, mean, std, seed: int,
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 hflip_p: float = 0.5, dct_scale: bool = False):
    """JPEG bytes -> RandomResizedCrop(``size``, ``scale``, ``ratio``) +
    flip with probability ``hflip_p`` + normalize, the draws from
    splitmix64 seeded with ``seed``. ``dct_scale`` decodes at >= 2x the
    crop target. None where the native path cannot decode."""
    lib = _load()
    if lib is None or not is_jpeg(data):
        return None
    out = np.empty((size, size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    buf = np.frombuffer(data, np.uint8)
    rc = lib.ip_decode_train(
        _ptr(buf, ctypes.c_uint8), len(data), size,
        float(scale[0]), float(scale[1]), float(ratio[0]), float(ratio[1]),
        float(hflip_p), ctypes.c_uint64(seed & (2 ** 64 - 1)).value or 1,
        _fvec(mean), _fvec(std), _ptr(out, ctypes.c_float),
        int(bool(dct_scale)))
    return out if rc == 0 else None


def _decode_eval_batch(datas, size: int, dtype, n_threads: int, invoke):
    """The batch calls' plumbing: the JPEGs among ``datas`` concatenated
    with their offsets, one C call (``invoke(lib, buf, offsets, n,
    n_threads, out, status)``), its results scattered back with an ok
    mask; non-JPEGs and failed decodes stay zero with ok False."""
    lib = _load()
    n = len(datas)
    out = np.zeros((n, size, size, 3), dtype)
    ok = np.zeros(n, bool)
    if lib is None or n == 0:
        return out, ok
    idx = [i for i, d in enumerate(datas) if is_jpeg(d)]
    if not idx:
        return out, ok
    buf = np.frombuffer(b"".join(datas[i] for i in idx), np.uint8)
    offsets = np.zeros(len(idx) + 1, np.uint64)
    np.cumsum([len(datas[i]) for i in idx], out=offsets[1:])
    sub = np.empty((len(idx), size, size, 3), dtype)
    status = np.empty(len(idx), np.int32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 8, 16)
    invoke(lib, buf, offsets, len(idx), n_threads, sub, status)
    for j, i in enumerate(idx):
        if status[j] == 0:
            out[i] = sub[j]
            ok[i] = True
    return out, ok


def decode_eval_batch(datas, size: int, mean, std, n_threads: int = 0,
                      dct_scale: bool = False):
    """JPEG byte strings -> ``(float32 [N, size, size, 3], ok [N])`` in one
    call on the in-library thread pool; entries with ok False (not a JPEG,
    or the decode failed) are zero, for the caller to decode with PIL."""
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)

    def invoke(lib, buf, offsets, nimg, nthr, sub, status):
        lib.ip_decode_eval_batch(
            _ptr(buf, ctypes.c_uint8), _ptr(offsets, ctypes.c_uint64), nimg,
            size, _fvec(mean), _fvec(std), nthr, _ptr(sub, ctypes.c_float),
            _ptr(status, ctypes.c_int32), int(bool(dct_scale)))

    return _decode_eval_batch(datas, size, np.float32, n_threads, invoke)


def decode_eval_batch_u8(datas, size: int, n_threads: int = 0,
                         dct_scale: bool = False):
    """:func:`decode_eval_batch` with uint8 crops
    (:func:`decode_eval_u8`)."""
    def invoke(lib, buf, offsets, nimg, nthr, sub, status):
        lib.ip_decode_eval_batch_u8(
            _ptr(buf, ctypes.c_uint8), _ptr(offsets, ctypes.c_uint64), nimg,
            size, nthr, _ptr(sub, ctypes.c_uint8),
            _ptr(status, ctypes.c_int32), int(bool(dct_scale)))

    return _decode_eval_batch(datas, size, np.uint8, n_threads, invoke)
