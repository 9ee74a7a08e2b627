"""compile_s: seconds of the circuit's compile by the port's frontend
(``frontend/builder.py`` and the configuration's gadgets) in set-up. Host
clock."""


def read(run):
    return run["setup"]["compile_s"]
