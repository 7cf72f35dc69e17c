"""Model zoo of the port: the Table-2 families as PyTorch shape programs."""
from .families import (FAMILIES, TABLE2_FRACTIONS, build_family,
                       family_variants, trace_family, variant_grid)
