"""Work across ranks on torch.distributed (counterpart of
shardmerge_tpu/parallel/): the fourier merge (``fft2d``, ``merge``,
``multihost``), tensor-parallel serving (``tp``) and training over a (dp, tp)
mesh (``mesh``, ``train``, ``optim``, ``checkpoint``, ``lora``)."""
