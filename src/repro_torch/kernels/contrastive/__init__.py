"""Online-contrastive loss: the CUDA forward and backward kernels
(`kernel`), their plain torch version (`ref`) and the dispatch between
them (`ops`)."""
