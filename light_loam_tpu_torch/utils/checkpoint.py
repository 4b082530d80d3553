"""Checkpoint / resume for SLAM state.

Counterpart of ``light_loam_tpu/utils/checkpoint.py``, writing the same
``.npz`` layout, so a snapshot taken by either package loads in the other:

  * ``frame``: the pipeline's frame counter;
  * ``odo__<i>``, ``map__<i>``: the leaves of ``OdometryState`` and
    ``MappingState`` in field order (nested clouds and stores flattened in
    place), each with the dtype and shape of the JAX package's leaf;
  * ``odo__treedef``, ``map__treedef``: the field paths of those leaves as
    text, written for a reader's eye and never read back;
  * ``extra__<name>``: whatever else the caller stores.

States cross to and from numpy through ``convert.py``, the one mapping
between the packages' states.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from light_loam_tpu_torch import convert
from light_loam_tpu_torch.models.mapping import MappingState
from light_loam_tpu_torch.models.odometry import OdometryState


def _leaf_paths(tree: dict, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested dict in insertion (= field) order."""
    out = []
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, dict):
            out += _leaf_paths(value, path + ".")
        else:
            out.append((path, value))
    return out


def _set_leaf(tree: dict, path: str, value) -> None:
    *parents, name = path.split(".")
    for p in parents:
        tree = tree[p]
    tree[name] = value


def _flatten(prefix: str, tree: dict, out: dict) -> None:
    leaves = _leaf_paths(tree)
    out[f"{prefix}__treedef"] = np.frombuffer(
        ", ".join(path for path, _ in leaves).encode(), dtype=np.uint8
    )
    for i, (_, leaf) in enumerate(leaves):
        out[f"{prefix}__{i}"] = leaf


def _unflatten(prefix: str, template: dict, data) -> dict:
    """``template`` with every leaf the snapshot holds put in its place.

    Leaves are stored positionally; fields appended to a state type since
    the snapshot show up as missing TRAILING indices and keep the template
    (init) value.  A missing index FOLLOWED by a present one means the
    field order changed — that cannot be mapped safely, so it stays an
    error."""
    leaves = _leaf_paths(template)
    present = [f"{prefix}__{i}" in data for i in range(len(leaves))]
    if any(p and not q for p, q in zip(present[1:], present[:-1])):
        raise ValueError(
            f"checkpoint is missing a non-trailing {prefix} leaf — "
            "state field order changed since the snapshot?"
        )
    for i, (path, leaf) in enumerate(leaves):
        if not present[i]:
            continue  # appended-field default
        arr = data[f"{prefix}__{i}"]
        if arr.shape != leaf.shape:
            raise ValueError(
                f"checkpoint shape mismatch at {prefix}[{i}]: "
                f"{arr.shape} vs {leaf.shape} — was the config "
                "changed since the snapshot?"
            )
        _set_leaf(template, path, arr)
    return template


def save_state(
    path: str,
    odo_state: OdometryState,
    map_state: MappingState,
    frame: int = 0,
    extra: dict | None = None,
) -> None:
    out: dict = {"frame": np.asarray(frame)}
    _flatten("odo", convert.odometry_state_to_numpy(odo_state), out)
    _flatten("map", convert.mapping_state_to_numpy(map_state), out)
    if extra:
        for k, v in extra.items():
            out[f"extra__{k}"] = np.asarray(v)
    np.savez_compressed(path, **out)


def load_state(
    path: str,
    odo_template: OdometryState,
    map_template: MappingState,
) -> Tuple[OdometryState, MappingState, int, dict]:
    """(odometry state, mapping state, frame, extras) of a snapshot, the
    states on the templates' device."""
    data = np.load(path)
    device = odo_template.q_w.device
    odo = convert.odometry_state_from_numpy(
        _unflatten("odo", convert.odometry_state_to_numpy(odo_template), data),
        device)
    mp = convert.mapping_state_from_numpy(
        _unflatten("map", convert.mapping_state_to_numpy(map_template), data),
        device)
    frame = int(data["frame"])
    extra = {
        k[len("extra__"):]: data[k] for k in data.files if k.startswith("extra__")
    }
    return odo, mp, frame, extra
