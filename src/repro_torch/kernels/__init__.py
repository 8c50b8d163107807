# Kernel layer of the port: each subpackage holds <name>.py (the CUDA
# kernel's wrapper beside its plain PyTorch version) and ops.py (the public
# wrappers); build.py compiles and loads csrc/.
