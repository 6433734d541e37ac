"""The fourier merge across ranks (counterpart of shardmerge_tpu/parallel/:
``fft2d``, ``merge`` and ``multihost``), on torch.distributed."""
