"""The JAX package's example flows as port modules (counterparts of
``examples/mnist_sparse.py``, ``mnist_qat.py``, ``voxel_gen.py``,
``fuse_bn_act.py``, ``int8_ptq_encoder.py``, ``dist_train.py`` and the
Python half of ``pjrt_loader/``, ``export_model.py``), each
run with ``python -m
spconv_tpu_torch.examples.<name>``; ``main(device=None, ...)`` runs on the
CUDA card unless the caller passes ``device="cpu"``."""
