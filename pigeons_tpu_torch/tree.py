"""Explorer states as trees: nested dicts, tuples and lists of tensors.

An explorer's adapted state is a tree: a dict of tensors ``[n_chains, ...]``
(``MALA``, ``NUTS``), ``()`` for an explorer that adapts nothing, or a tuple
of its components' states for a combinator (``Compose``, ``Mix``,
``ScanMix``). The JAX package handles it as a pytree (``jax.tree``); these
are the few tree functions the runtime, the checkpoint and the invariance
test need. A dict, a tuple or a list is a node, anything else a leaf; a
dict's entries go in insertion order.
"""

from __future__ import annotations


def tree_map(fn, tree):
    """``tree`` with every leaf ``v`` replaced by ``fn(v)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    """The leaves of ``tree``, in order."""
    out = []
    tree_map(out.append, tree)
    return out


def structure(tree):
    """``tree`` with every leaf replaced by ``None``: what
    :func:`unflatten` needs to rebuild it (plain data, so it pickles)."""
    return tree_map(lambda _: None, tree)


def unflatten(struct, values):
    """The tree of ``struct`` (from :func:`structure`) with its leaves taken
    from ``values`` in order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), struct)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure has")
    return out
