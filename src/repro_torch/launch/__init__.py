"""Command-line launchers of the port (``python -m repro_torch.launch.<x>``).

``serve``  the solve server and its threaded client harness
"""
