"""Command-line launchers of the port (``python -m repro_torch.launch.<x>``).

``solve``  the distributed solve on a (p1, p2) grid of ranks, its timed
           ``--steps`` loop and the survivable ``--ckpt`` loop
``serve``  the solve server and its threaded client harness
``train``  the LM training launcher (checkpoints, resume, ``--fail-at``)
``cases``  the paper's analytical validation fields (numpy)
"""
