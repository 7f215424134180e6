"""The harness's own tests (CPU, tiny sizes; the `cuda` ones need a card):
    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
