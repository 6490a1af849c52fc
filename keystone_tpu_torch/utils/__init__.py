"""Helpers shared by the workloads — port of ``keystone_tpu/utils``."""
