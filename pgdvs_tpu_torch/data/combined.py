"""Dataset registry + flat concatenation across sub-datasets.

The counterpart of ``pgdvs_tpu.data.combined``: a named registry of the
JAX package's five readers (``nvidia_eval``, ``nvidia_eval_pure_geo``,
``nvidia_vis``, ``mono_vis``, ``dycheck_iphone_eval``) and one flat index
space over the concatenation of the selected datasets.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

DATASET_REGISTRY: Dict[str, type] = {}


def register_dataset(name: str):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls

    return deco


def _populate():
    from pgdvs_tpu_torch.data.dycheck_iphone import DyCheckIPhoneEvalDataset
    from pgdvs_tpu_torch.data.mono_vis import MonoVisDataset
    from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
    from pgdvs_tpu_torch.data.nvidia_pure_geo import NvidiaPureGeoEvalDataset
    from pgdvs_tpu_torch.data.nvidia_vis import NvidiaVisDataset

    DATASET_REGISTRY.setdefault("nvidia_eval", NvidiaEvalDataset)
    DATASET_REGISTRY.setdefault("nvidia_eval_pure_geo", NvidiaPureGeoEvalDataset)
    DATASET_REGISTRY.setdefault("nvidia_vis", NvidiaVisDataset)
    DATASET_REGISTRY.setdefault("mono_vis", MonoVisDataset)
    DATASET_REGISTRY.setdefault("dycheck_iphone_eval", DyCheckIPhoneEvalDataset)


class CombinedDataset:
    """Concatenation of named datasets sharing one flat index space."""

    def __init__(self, dataset_specs: Sequence[tuple]):
        """dataset_specs: sequence of (name, kwargs-dict)."""
        _populate()
        self.datasets: List = []
        for name, kwargs in dataset_specs:
            if name not in DATASET_REGISTRY:
                raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASET_REGISTRY)}")
            self.datasets.append(DATASET_REGISTRY[name](**kwargs))
        self._offsets = []
        total = 0
        for d in self.datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, index):
        for ds, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if index >= off:
                return ds[index - off]
        raise IndexError(index)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
