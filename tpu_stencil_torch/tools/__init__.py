"""The port's measuring tools: ``python -m tpu_stencil_torch.tools.<name>``.

``kernel_lab`` times the lab variants of the fused kernel (L2),
``op_cost`` costs single operations (L1), ``bh_fuse_ab`` sweeps the
shipped kernel's tile height and fuse, ``http_tax`` splits the network
tier's requests/s from the in-process server's. Each runs on the GPU unless
``--platform cpu`` asks for a rehearsal on the plain versions, and exits
non-zero when a variant is not exact.
"""
