"""Workload configurations of the CT port."""
