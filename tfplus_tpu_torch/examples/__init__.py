"""Twins of the repository's ``examples/`` scripts on the port.

Run one as ``python -m tfplus_tpu_torch.examples.<name> [--cpu]``: without
``--cpu`` it runs on ``cuda`` and raises when there is no card. Each keeps
its original's flags and printed lines, and its ``main(argv=None)`` returns
the metrics it prints. ``train_dlrm_sharded`` runs one process per rank
under ``torchrun --nproc-per-node=N`` (gloo with ``--cpu``, NCCL on cards).
"""
