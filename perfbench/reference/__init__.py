"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, in float32 with TF32 off. It imports nothing of the
program under test and nothing of JAX: it holds its own copy of the
hash-bucket tokenizer (:mod:`.tokenizer`), the published CLIP towers
(:mod:`.clip`), the exact searches (:mod:`.search`) and the numbers that
compare an answer with it (:mod:`.compare`).
"""
