"""The LM shape cells' sizes (train_4k / prefill_32k / decode_32k /
long_500k).

The port's copy of ``repro/configs/lm_shapes.py``: the four shape dicts
only (the cell builders wait for the port's dry-run analog).
"""
TRAIN_4K = dict(seq=4096, global_batch=256)
PREFILL_32K = dict(seq=32768, global_batch=32)
DECODE_32K = dict(cache=32768, global_batch=128)
LONG_500K = dict(cache=524288, global_batch=1)
