"""Carry ``aux`` (weights), DSP state and engine checkpoints between the two
packages.

The JAX package keeps per-module ``aux`` and state as pytrees of arrays
(dicts keyed by module id key, then by leaf name).  Convert them with
``np.asarray`` on the JAX side; ``to_torch`` turns such a numpy pytree into
the port's tensors on a given device and ``to_numpy`` turns the port's
pytree back.  Leaf types: bool stays bool (envelope ``mode_on``), integers
become int32 (envelope positions), everything else float32.  Dicts, tuples,
lists and ``None`` keep their structure.

Stacked trees (a fleet's or the stems' ``aux`` and state, every leaf
[n, ...] on a leading instance axis) convert the same way, leaf by leaf: the
JAX ``Fleet``'s host-numpy ``aux`` and device state become the port's
``Fleet.aux`` (numpy, as there) and ``Fleet.state`` (tensors, a stacked
tree a shard) with ``fleet_from_jax`` and go back with ``fleet_to_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.bool_:
        dtype = np.bool_
    elif np.issubdtype(a.dtype, np.integer):
        dtype = np.int32
    else:
        dtype = np.float32
    # astype copies: the tensor never aliases (possibly read-only) jax memory
    return torch.from_numpy(a.astype(dtype)).to(device)


def to_torch(tree, device: torch.device):
    """Numpy (or array-like) pytree -> tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def to_numpy(tree):
    """The port's tensor pytree -> numpy arrays on the host."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def tree_map(fn, *trees):
    """``fn`` applied leaf by leaf to trees of one structure (the first
    tree's); ``None`` stays ``None``."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack(trees, xp=None):
    """Trees of one structure -> one tree with every leaf stacked on a new
    leading axis: tensors with ``torch.stack``, anything else with
    ``np.stack``."""
    def leaf(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return tree_map(leaf, *trees)


def fleet_from_jax(jax_fleet, fleet) -> None:
    """Give the port's ``fleet`` (``parallel.fleet.Fleet``) the aux and DSP
    state of the JAX package's ``jax_fleet`` (same workspace, same n):
    ``aux`` as host numpy, each shard's rows of the state as tensors on its
    device."""
    fleet.aux = tree_map(lambda mine, theirs: np.asarray(theirs).astype(mine.dtype),
                         fleet.aux, jax_fleet.aux)
    fleet.aux_changed()
    fleet.state = [tree_map(
        lambda mine, theirs, sh=sh: _leaf_to_torch(np.asarray(theirs)[sh.lo:sh.hi],
                                                   mine.device).to(mine.dtype),
        st, jax_fleet.state) for sh, st in zip(fleet.shards, fleet.state)]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fleet_to_numpy(fleet):
    """A fleet's ``(aux, state)`` as numpy trees (either package's fleet:
    the port's state, one stacked tree a shard, joined in instance
    order)."""
    state = fleet.state
    if isinstance(state, list):
        state = tree_map(lambda *xs: np.concatenate([_host(x) for x in xs]), *state)
    return tree_map(np.asarray, fleet.aux), tree_map(_host, state)


# ---------------------------------------------------------------------------
# engine checkpoints (``Engine.checkpoint`` / ``restore_dsp_state``)
# ---------------------------------------------------------------------------
#
# Both engines' checkpoints are ``{"workspace": persist dict, "tick": int,
# "dsp_state": [numpy leaves]}``, the leaves in ``jax.tree.flatten`` order
# of the state pytree: dict keys sorted, tuples and lists in order, ``None``
# holding no leaf.  Listing the port's leaves in that order makes a
# checkpoint restore into either engine.


def tree_leaves(tree) -> list:
    """The leaves of a pytree in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """``template`` with its leaves replaced, in ``tree_leaves`` order, by
    ``leaves`` (as many as ``tree_leaves(template)`` holds)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def state_leaves_to_numpy(state) -> list:
    """A DSP state pytree (tensor or numpy leaves) -> a checkpoint's
    ``dsp_state`` list."""
    return [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in tree_leaves(state)]


def state_from_leaves(template, leaves):
    """A checkpoint's ``dsp_state`` (numpy leaves from either engine) -> the
    port's state with ``template``'s structure, dtypes and devices (each
    leaf on its template leaf's), or None if the leaves do not fit the
    template (count or shapes)."""
    slots = tree_leaves(template)
    if len(slots) != len(leaves):
        return None
    new = []
    for slot, leaf in zip(slots, leaves):
        a = np.asarray(leaf)
        if tuple(a.shape) != tuple(slot.shape):
            return None
        dtype = torch.empty(0, dtype=slot.dtype).numpy().dtype
        new.append(torch.from_numpy(a.astype(dtype)).to(slot.device))
    return tree_unflatten(template, new)
