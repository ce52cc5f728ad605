"""ctypes bindings for the native AV1 entropy engine (av1_enc.cpp).

The native engine is a byte-exact twin of av1_entropy.MsacEncoder +
av1_intra.TileEncoder.encode_txb (pinned by tests/test_av1_native.py's
equality suite and the dav1d conformance gates).

The port's copy of ``imagekit_tpu/codecs/native/av1_abi.py``, bound
through the port's loader. Where the reference falls back to the
pure-Python engine (~40x slower) on any failure, the port raises: a
library that cannot be built, lacks the engine's symbols or disagrees
with the tables' shapes is a fault, not a slower path. The pure-Python
engine stays reachable for its equality test, which sets
``_state["native"]`` to False.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import loader

_lock = threading.Lock()
_state: dict = {"lib": None, "native": True}


# expected table shapes — the C engine hard-codes these strides
_SHAPES = {
    "txb_skip": (4, 5, 13, 3),
    "intra_ext_tx2": (4, 13, 6),
    "eob_pt_16": (4, 2, 2, 6),
    "eob_pt_64": (4, 2, 2, 8),
    "eob_pt_256": (4, 2, 2, 10),
    "eob_pt_1024": (4, 2, 2, 12),
    "eob_extra": (4, 5, 2, 9, 3),
    "coeff_base_eob": (4, 5, 2, 4, 4),
    "coeff_base": (4, 5, 2, 42, 5),
    "coeff_br": (4, 5, 2, 21, 5),
    "dc_sign": (4, 2, 3, 3),
    "scan_4x4": (16,),
    "scan_8x8": (64,),
    "scan_16x16": (256,),
    "scan_32x32": (1024,),
}


def _bind(lib: ctypes.CDLL) -> None:
    lib.ik_msac_new.restype = ctypes.c_void_p
    lib.ik_msac_free.argtypes = [ctypes.c_void_p]
    lib.ik_msac_reset.argtypes = [ctypes.c_void_p]
    lib.ik_msac_symbol.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int]
    lib.ik_msac_symbol_adapt.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int]
    lib.ik_msac_literal.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_int]
    lib.ik_msac_golomb.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ik_msac_nbits.argtypes = [ctypes.c_void_p]
    lib.ik_msac_nbits.restype = ctypes.c_longlong
    lib.ik_msac_done.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int]
    lib.ik_msac_done.restype = ctypes.c_int
    lib.ik_msac_clone.argtypes = [ctypes.c_void_p]
    lib.ik_msac_clone.restype = ctypes.c_void_p
    lib.ik_msac_assign.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ik_av1_bind_tables.argtypes = [ctypes.c_void_p] * 15
    lib.ik_av1_txb.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int]
    lib.ik_av1_txb.restype = ctypes.c_int
    lib.ik_av1_recon.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.ik_av1_leaf_eval.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.ik_av1_leaf_eval.restype = ctypes.c_longlong


def load() -> Optional[ctypes.CDLL]:
    """The shared native library with its tables bound; None only where
    ``_state["native"]`` is False. Raises where the library cannot be
    built, lacks the engine's symbols or the tables' shapes drift."""
    with _lock:
        if not _state["native"]:
            return None
        if _state["lib"] is not None:
            return _state["lib"]
        lib = loader.load()  # raises where the library cannot be built
        if not hasattr(lib, "ik_av1_txb"):
            raise RuntimeError(
                f"{lib._name} lacks the AV1 entropy engine (av1_enc.cpp)")
        _bind(lib)
        from ..av1_entropy import tables

        T = tables()
        holders = []
        ptrs = []
        for name, shape in _SHAPES.items():
            arr = np.ascontiguousarray(T[name])
            if arr.shape != shape:  # the C engine hard-codes the strides
                raise RuntimeError(f"AV1 table {name} has shape "
                                   f"{arr.shape}, the engine's is {shape}")
            holders.append(arr)             # keep buffers alive
            ptrs.append(arr.ctypes.data_as(ctypes.c_void_p))
        lib.ik_av1_bind_tables(*ptrs)
        _state["holders"] = holders
        _state["lib"] = lib
        return lib
