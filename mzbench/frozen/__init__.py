"""Frozen copies of ``multiz_tpu_torch``'s framework-free host modules at
commit 1de2067 (each file names its original), with the native runtime
never loaded: the benchmark's inputs and its reference are made with
these, so that neither imports the program."""
