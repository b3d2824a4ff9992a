from .fast_forward import rat_m2_fast_forward
from .rat import VARIANTS, RATModel, build_model
