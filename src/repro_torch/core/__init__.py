"""D&A core: the paper's resource-optimisation framework, numpy only.

A copy of what ``repro.core`` holds for Algorithms 1 and 2:
    cochran_sample_size, fraction_sample_size   (paper Eq. 1 / §IV-A)
    RuntimeStats                                (paper t_i statistics)
    lemma1_lower_bound, lemma2_hoeffding_bound  (paper Lemma 1 / Lemma 2)
    dna, dna_real                               (paper Alg. 1 / Alg. 2)
"""

from .bounds import (BoundReport, InfeasibleDeadline, lemma1_lower_bound,
                     lemma2_hoeffding_bound, minimal_feasible_deadline,
                     required_cores)
from .dna import DnaResult, dna, dna_real
from .estimator import RuntimeStats
from .sampling import (SamplePlan, Z_TABLE, cochran_sample_size,
                       fraction_sample_size, z_score)
from .slots import (SlotExecution, SlotPlan, build_slot_plan, execute_plan,
                    num_slots, queries_per_slot)

__all__ = [
    "BoundReport", "DnaResult", "InfeasibleDeadline", "RuntimeStats",
    "SamplePlan", "SlotExecution", "SlotPlan", "Z_TABLE", "build_slot_plan",
    "cochran_sample_size", "dna", "dna_real", "execute_plan",
    "fraction_sample_size", "lemma1_lower_bound", "lemma2_hoeffding_bound",
    "minimal_feasible_deadline", "num_slots", "queries_per_slot",
    "required_cores", "z_score",
]
