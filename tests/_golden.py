"""Golden files of nested references: a tree of dicts and dataclasses over
arrays, stored in an .npz file as one entry a leaf, under its dotted path
("tape.contact.idx"). `load` gives the tree back as nested dicts; a caller
turns a subtree into the dataclass its tests read."""
import dataclasses

import numpy as np


def entries(tree, prefix=""):
    """{dotted path: array} of every leaf of `tree`."""
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(entries(value, f"{prefix}{key}."))
    return out


def save(path, tree):
    np.savez_compressed(path, **entries(tree))


def load(path):
    tree = {}
    with np.load(path) as g:
        for key in g.files:
            *parents, leaf = key.split(".")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = g[key]
    return tree


def assert_current(path, tree, assert_entry):
    """The file at `path` holds the leaves of `tree`, recomputed: the same
    entries, each passing assert_entry(key, stored, recomputed)."""
    want = entries(tree)
    with np.load(path) as stored:
        assert sorted(stored.files) == sorted(want)
        for key, w in want.items():
            assert_entry(key, stored[key], w)
