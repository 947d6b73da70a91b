"""Composite dataset over a nested dict of member datasets (counterpart of
``unicore_tpu/data/nested_dictionary_dataset.py``): members are addressed
by dotted paths ("net_input.src_tokens"), each member collates its own
column, and the batch is re-nested in the collater."""

from collections import OrderedDict

from .data_utils import default_collate
from .unicore_dataset import UnicoreDataset


def _flatten(tree, prefix=None):
    """(dotted_path, leaf) pairs of a nested dict/list tree; list positions
    encode as ``.[i]`` segments; None leaves drop."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if v is None:
                continue
            path = k if prefix is None else f"{prefix}.{k}"
            yield from _flatten(v, path)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}.[{i}]")
    else:
        yield prefix, tree


def _unflatten(flat):
    root = OrderedDict()
    for path, value in flat.items():
        segments = path.split(".")
        node = root
        for seg in segments[:-1]:
            if seg[:1] == "[" and seg[-1:] == "]":
                seg = int(seg[1:-1])
            node = node.setdefault(seg, OrderedDict())
        node[segments[-1]] = value
    return root


class NestedDictionaryDataset(UnicoreDataset):
    def __init__(self, defn):
        super().__init__()
        self.defn = OrderedDict(_flatten(defn))
        lengths = set()
        for ds in self.defn.values():
            if not isinstance(ds, UnicoreDataset):
                raise ValueError(f"Expected UnicoreDataset but found: {ds.__class__}")
            if len(ds) > 0:
                lengths.add(len(ds))
        if len(lengths) > 1:
            raise AssertionError(f"dataset lengths must match, got {lengths}")
        self._len = lengths.pop() if lengths else 0

    def __len__(self):
        return self._len

    def __getitem__(self, index):
        return OrderedDict((path, ds[index]) for path, ds in self.defn.items())

    def collater(self, samples):
        if len(samples) == 0:
            return {}
        columns = OrderedDict()
        for path, ds in self.defn.items():
            column = [s[path] for s in samples]
            try:
                columns[path] = ds.collater(column)
            except NotImplementedError:
                columns[path] = default_collate(column)
        return _unflatten(columns)

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return all(ds.can_reuse_epoch_itr_across_epochs for ds in self.defn.values())

    def set_epoch(self, epoch):
        super().set_epoch(epoch)
        for ds in self.defn.values():
            ds.set_epoch(epoch)
