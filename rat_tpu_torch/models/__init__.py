from .fast_forward import rat_m2_fast_forward
from .rat import VARIANTS, RATModel, build_model

# the JAX package's model-name aliases (rat_tpu/models/__init__.py)
RAT_m0 = "RAT_m0"
RAT_m1 = "RAT_m1"
RAT_m2 = "RAT_m2"
RAT_m3 = "RAT_m3"
