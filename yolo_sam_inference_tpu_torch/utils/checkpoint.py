"""Model parameter checkpoints: flat ``.npz`` files of parameter trees.

Counterpart of ``yolo_sam_inference_tpu/utils/checkpoint.py``. A tree
(nested dicts and lists, numpy or torch leaves, None leaves skipped) is
saved as one array per leaf under the key of its path joined by ``"::"``
(``vision::layers::0::attn::qkv::w``), the JAX module's keys, so a file
written by either package loads in the other. Loading rebuilds the
structure of a ``like`` tree and checks every shape. The fine-tune step
(``parallel/train.py``) produces the trees this saves; its tensor-parallel
state is gathered to a whole tree first (``train.gather_params``).

The JAX module saves a directory with orbax where orbax imports; the port
has no orbax, and behaves as the JAX module does without it: ``save_params``
writes ``.npz`` (a path without that suffix gets it) and loading a directory
raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

from .logger import setup_logger

logger = setup_logger(__name__)

_SEP = "::"


def _array(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """{path key: leaf} of a tree in JAX's order (dict keys sorted, list
    items by index); None leaves are skipped."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {} if tree is None else {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return flat


def unflatten_like(flat: Dict[str, Any], like, prefix: str = ""):
    """A tree of ``like``'s structure whose leaves are ``flat[key]`` (None
    leaves stay None)."""
    def key(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: unflatten_like(flat, v, key(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten_like(flat, v, key(i)) for i, v in enumerate(like))
    return None if like is None else flat[prefix]


def save_params_npz(params, path) -> None:
    """Flat-key .npz save of a parameter tree."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _array(v) for k, v in flatten_tree(params).items()}
    np.savez_compressed(path, **flat)
    logger.info("saved %d arrays to %s", len(flat), path)


def load_params_npz(path, like) -> Any:
    """Restore into the structure of ``like`` (shapes validated); numpy leaves."""
    with np.load(Path(path), allow_pickle=False) as z:
        data = dict(z)
    flat = {}
    for key, leaf in flatten_tree(like).items():
        if key not in data:
            raise KeyError(f"checkpoint missing parameter {key}")
        arr = data[key]
        if arr.shape != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {np.shape(leaf)}")
        flat[key] = arr
    return unflatten_like(flat, like)


def save_params(params, path) -> None:
    """``.npz`` save: at ``path`` where it ends in ``.npz``, else at ``path``
    with that suffix (the JAX module's fallback where orbax does not import)."""
    path = Path(path)
    save_params_npz(params, path if path.suffix == ".npz" else path.with_suffix(".npz"))


def load_params(path, like) -> Any:
    """Load ``path``, or ``path`` with ``.npz`` where only that exists; a
    directory (an orbax checkpoint of the JAX package) raises."""
    path = Path(path)
    if path.suffix == ".npz" or path.with_suffix(".npz").exists() and not path.exists():
        return load_params_npz(path if path.suffix == ".npz" else path.with_suffix(".npz"), like)
    raise ImportError(f"{path}: an orbax checkpoint directory; the PyTorch port reads .npz "
                      "checkpoints only (save one with save_params_npz)")


__all__ = ["flatten_tree", "load_params", "load_params_npz", "save_params", "save_params_npz",
           "unflatten_like"]
