"""The shared LM-family shape set (brief: seq_len × global_batch)."""

from repro_torch.configs.base import ShapeSpec

LM_SHAPES = (
    ShapeSpec.make("train_4k", "lm_train", seq_len=4096, global_batch=256),
    ShapeSpec.make("prefill_32k", "lm_prefill", seq_len=32768, global_batch=32),
    ShapeSpec.make("decode_32k", "lm_decode", seq_len=32768, global_batch=128),
    ShapeSpec.make("long_500k", "lm_long_decode", seq_len=524288, global_batch=1),
)
