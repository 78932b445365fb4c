from vis_tpu_torch.safety.consensus import ConsensusAnalyzer, analyze_consensus
from vis_tpu_torch.safety.gates import SafetyGateEngine, evaluate_safety, load_safety_rules
from vis_tpu_torch.safety.image_quality import assess_image_quality

__all__ = [
    "analyze_consensus",
    "ConsensusAnalyzer",
    "evaluate_safety",
    "SafetyGateEngine",
    "load_safety_rules",
    "assess_image_quality",
]
