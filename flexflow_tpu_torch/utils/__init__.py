"""Utility subpackage: the port of flexflow_tpu/utils/."""
