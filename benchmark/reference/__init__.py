"""Plain PyTorch references that decide whether a run is `correct`. They
import neither JAX nor anything of the program."""
