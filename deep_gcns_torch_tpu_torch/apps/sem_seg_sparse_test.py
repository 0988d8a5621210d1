"""Score a SparseDeepGCN S3DIS checkpoint (counterpart of
`examples/sem_seg_sparse/test.py`), both ways `apps/sem_seg_dense_test`
does: the training run's mIoU and the area-level protocol.

    python -m deep_gcns_torch_tpu_torch.apps.sem_seg_sparse_test --synthetic \\
        --pretrained_model <exp>/ckpt_best [the training run's data and model flags]
"""

from __future__ import annotations

from typing import Optional, Sequence

from . import sem_seg_sparse as app
from .sem_seg_dense_test import score


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return score(app, argv, "sem_seg_sparse")


if __name__ == "__main__":
    main()
