"""Data and tensor parallelism over ``torch.distributed`` (``mesh.py``,
``tp.py``): the port's counterpart of ``w2v2_speaker_tpu/parallel/``."""
