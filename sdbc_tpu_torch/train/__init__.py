"""Fine-tuning (counterpart of ``sdbc_tpu/train``): the trainer's full
fine-tune branch (``trainer.py``) and the 8-bit AdamW (``adam8bit.py``)."""
