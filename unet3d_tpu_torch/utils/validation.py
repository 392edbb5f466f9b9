"""Input-validation helpers with instructive error messages."""
from __future__ import annotations


def validate_batch_item(batch: dict, key: str, context: str = "prediction") -> None:
    """Raise a KeyError with guidance when a loader batch misses a field."""
    if key not in batch:
        raise KeyError(
            f"Batch is missing the '{key}' entry required for {context}. "
            f"Available keys: {sorted(batch.keys())}. Batches carry "
            "image/affine/source_filename (and label during training).")
