"""setup_s: seconds from the process's start to the window's start: imports,
the kernel library's load, the circuit's compile and levels, the seeded
keygen, the first input and one warm-up prove. A checkout's first run also
builds the library with nvcc: that build is printed on a line of its own
and left out. Host clock."""


def read(run):
    return run["setup"]["setup_s"]
