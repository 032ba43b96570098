"""D&A core: the paper's resource-optimisation framework, numpy only.

A copy of ``repro.core``:
    cochran_sample_size, fraction_sample_size   (paper Eq. 1 / §IV-A)
    RuntimeStats, TimeSource family             (paper t_i statistics)
    lemma1_lower_bound, lemma2_hoeffding_bound  (paper Lemma 1 / Lemma 2)
    dna, dna_real                               (paper Alg. 1 / Alg. 2)
    DeviceAllocator, StragglerMonitor           (the device layer)
    MeshPlan, plan_core_mesh                    (cores -> devices x lanes)
"""

from .allocator import (Admission, DeviceAllocator, MeshPlan,
                        StragglerMonitor, plan_core_mesh)
from .bounds import (BoundReport, InfeasibleDeadline, lemma1_lower_bound,
                     lemma2_hoeffding_bound, minimal_feasible_deadline,
                     required_cores)
from .dna import DnaResult, dna, dna_real
from .estimator import (CacheAwareCostModel, MeasuredTimeSource,
                        RooflineTerms, RooflineTimeSource, RuntimeStats,
                        SimulatedTimeSource, TimeSource)
from .sampling import (SamplePlan, Z_TABLE, cochran_sample_size,
                       fraction_sample_size, z_score)
from .slots import (SlotExecution, SlotPlan, build_slot_plan, execute_plan,
                    num_slots, queries_per_slot)

__all__ = [
    "Admission", "BoundReport", "CacheAwareCostModel", "DeviceAllocator",
    "DnaResult", "InfeasibleDeadline", "MeasuredTimeSource", "MeshPlan",
    "RooflineTerms", "RooflineTimeSource", "RuntimeStats", "SamplePlan",
    "SimulatedTimeSource", "SlotExecution", "SlotPlan", "StragglerMonitor",
    "TimeSource", "Z_TABLE", "build_slot_plan", "cochran_sample_size", "dna",
    "dna_real", "execute_plan", "fraction_sample_size", "lemma1_lower_bound",
    "lemma2_hoeffding_bound", "minimal_feasible_deadline", "num_slots",
    "plan_core_mesh", "queries_per_slot", "required_cores", "z_score",
]
