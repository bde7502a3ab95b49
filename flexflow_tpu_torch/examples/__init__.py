"""The repo's example scripts (examples/*.py) on the port, one module
each, run as ``python -m flexflow_tpu_torch.examples.<name> [flags]``.
Each has ``main(argv=None, config=None)`` and returns what it trained;
``common`` holds their shared runner."""
