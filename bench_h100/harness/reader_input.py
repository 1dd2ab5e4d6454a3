"""What a run hands the per-layer readers (``metrics/<name>.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Readings:
    """Readers run only on the card, in a traced run.  ``kind``: the
    traffic's driver (``eval_split`` or ``train_epochs``); ``trace``: the
    reduced capture (``harness.trace.Trace``); ``dtype``: the configuration's
    compute dtype; ``flops_per_patch`` and ``convs``: one forward's FLOPs
    and 3x3 conv shapes at the traffic's patch size (``model_cost``);
    ``counts``: what the traced part of the window did (eval: ``splits``,
    ``images``, ``patches``, ``chunks`` of one split; train: ``steps``,
    ``train_patches``, ``val_passes``, ``val_patches``); ``host``: host-clock
    lists of the whole window (train: ``val_pass_s`` of the untraced
    epochs)."""

    kind: str
    dtype: str
    flops_per_patch: int
    convs: list
    trace: object = None
    counts: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)
