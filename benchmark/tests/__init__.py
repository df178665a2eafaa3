"""The benchmark's own tests: python -m pytest benchmark/tests -q"""
