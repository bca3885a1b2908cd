"""Fused cascade lookup: the CUDA kernel (`kernel`), its plain torch
version (`ref`) and the dispatch between them (`ops`)."""
