"""Nested dicts of tensors as pytrees (the port's counterpart of
``jax.tree_util`` and ``jax.flatten_util.ravel_pytree``).

Leaves are visited in SORTED-KEY order, the order in which JAX flattens a
dict, so a flat vector of the port lines up element for element with
``ravel_pytree`` of the same dict in ``dafoam_tpu`` (recycle spaces and
adjoint vectors carried across with ``convert.py`` rely on it).
"""

from __future__ import annotations

import torch


def leaves(tree) -> list:
    """The tensors of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def tmap(f, *trees):
    """f applied leaf by leaf; the result has the first tree's structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tmap(f, *(t[k] for t in trees)) for k in t0}
    return f(*trees)


def unflatten(like, new_leaves):
    """A tree shaped like ``like`` holding ``new_leaves`` (sorted-key
    order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    return tmap(lambda a, b: b, like, out)   # restore the key order of like


def ravel(tree):
    """(flat vector, unravel) as ``jax.flatten_util.ravel_pytree``."""
    ls = leaves(tree)
    shapes = [leaf.shape for leaf in ls]
    sizes = [leaf.numel() for leaf in ls]
    flat = torch.cat([leaf.reshape(-1) for leaf in ls]) if len(ls) > 1 \
        else ls[0].reshape(-1)

    def unravel(u):
        parts = torch.split(u, sizes) if len(sizes) > 1 else (u,)
        return unflatten(tree, [p.reshape(s) for p, s in zip(parts, shapes)])

    return flat, unravel
