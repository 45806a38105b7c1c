"""The shared RecSys-family shape set."""

from repro_torch.configs.base import ShapeSpec

RECSYS_SHAPES = (
    ShapeSpec.make("train_batch", "recsys_train", batch=65536),
    ShapeSpec.make("serve_p99", "recsys_serve", batch=512),
    ShapeSpec.make("serve_bulk", "recsys_serve", batch=262_144),
    ShapeSpec.make(
        "retrieval_cand", "recsys_retrieval", batch=1, n_candidates=1_000_000
    ),
)
