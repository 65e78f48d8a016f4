"""The benchmark harness of the PyTorch port (``smk_torch``): inputs made
from a seed, the port's random numbers drawn again for the reference,
the closed loop of whole fits, the reading of the profiler trace, the
work counts and the plain reference that decides ``correct``. Only
``port.py`` imports the port; nothing here imports JAX or the JAX
package."""
