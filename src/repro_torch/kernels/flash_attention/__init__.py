"""Blocked online-softmax attention of prefill and the full sequence:
the CUDA kernel (`kernel`), its plain torch version (`ref`) and the
dispatch between them (`ops`)."""
