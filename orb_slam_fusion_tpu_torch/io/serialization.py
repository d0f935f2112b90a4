"""Map / session checkpointing.

Counterpart of ``orb_slam_fusion_tpu/io/serialization.py`` (reference:
System::SaveAtlas/LoadAtlas, src/system.cc:1391-1527): a checkpoint is one
compressed ``.npz`` of the map's flat arrays, with the MD5 of the
vocabulary beside it (the reference's checksum guard, system.cc:1417).

The files are interchangeable with the JAX package's: the same keys,
shapes and dtypes (descriptors as ``uint32`` words, not the port's int32
bit patterns), and the guard hashes the same bytes (the vocabulary's
``(V, 8)`` words as ``uint32``), so either package loads the other's
atlas.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..map.convert import desc_to_numpy, map_state_from_numpy, \
    map_state_to_numpy
from ..map.map_state import MapState

FORMAT_VERSION = 2
# fields added after v1 checkpoints, loaded with defaults when absent
_V2_DEFAULTS = {
    "mp_min_dist": lambda M: np.zeros(M, np.float32),
    "mp_max_dist": lambda M: np.full(M, 1e9, np.float32),
}


def _words_numpy(words) -> np.ndarray:
    """Vocabulary words as ``uint32`` numpy (a port tensor holds them as
    int32 bit patterns)."""
    if torch.is_tensor(words):
        return desc_to_numpy(words)
    return np.asarray(words, np.uint32)


def vocab_checksum(words) -> str:
    return hashlib.md5(_words_numpy(words).tobytes()).hexdigest()


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def map_to_arrays(m: MapState, prefix: str = "") -> dict:
    """Flatten a MapState into named numpy arrays (pose split into R/t)."""
    fields = map_state_to_numpy(m)
    R, t = fields.pop("kf_pose")
    d = {prefix + "kf_pose_R": R, prefix + "kf_pose_t": t}
    for name in MapState._fields:
        if name != "kf_pose":
            d[prefix + name] = fields[name]
    return d


def map_from_arrays(get: Callable[[str], Optional[np.ndarray]],
                    prefix: str = "", device=None) -> MapState:
    """Rebuild a MapState on ``device`` from a name->array accessor
    (``get(name)`` returns the array or None for fields absent in older
    checkpoints)."""
    fields = {}
    max_mp = get(prefix + "mp_valid").shape[0]
    for name in MapState._fields:
        if name == "kf_pose":
            continue
        arr = get(prefix + name)
        if arr is None and name in _V2_DEFAULTS:
            arr = _V2_DEFAULTS[name](max_mp)
        fields[name] = arr
    fields["kf_pose"] = (get(prefix + "kf_pose_R"), get(prefix + "kf_pose_t"))
    return map_state_from_numpy(fields, device)


def save_map(path: str, m: MapState, vocab_words=None,
             **extra_arrays) -> None:
    """Write a map checkpoint (plus optional extra arrays, e.g. kf_uright,
    velocities/biases for inertial sessions, archived atlas maps)."""
    payload = {"format_version": np.int64(FORMAT_VERSION)}
    payload.update(map_to_arrays(m))
    if vocab_words is not None:
        payload["vocab_md5"] = np.frombuffer(
            vocab_checksum(vocab_words).encode(), dtype=np.uint8)
    for k, v in extra_arrays.items():
        payload["extra_" + k] = _host(v)
    np.savez_compressed(path, **payload)


def load_map(path: str, vocab_words=None, device=None
             ) -> Tuple[MapState, dict]:
    """Read a checkpoint onto ``device``; verifies the vocabulary checksum
    if given (reference behaviour: refuse to load an atlas built with a
    different vocabulary, system.cc:1477). The extra arrays come back as
    numpy arrays, keyed without their ``extra_`` prefix."""
    z = np.load(path, allow_pickle=False)
    ver = int(z["format_version"])
    if ver > FORMAT_VERSION or ver < 1:
        raise ValueError(f"checkpoint format {ver} != {FORMAT_VERSION}")
    if vocab_words is not None and "vocab_md5" in z:
        stored = bytes(z["vocab_md5"]).decode()
        if stored != vocab_checksum(vocab_words):
            raise ValueError(
                "vocabulary checksum mismatch — this map was built with a "
                "different vocabulary")
    m = map_from_arrays(lambda n: z[n] if n in z.files else None,
                        device=device)
    extras = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return m, extras
