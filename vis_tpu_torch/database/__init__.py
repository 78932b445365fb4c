from vis_tpu_torch.database.models import DefectRecord, InspectionRecord
from vis_tpu_torch.database.repository import (
    InspectionRepository,
    health_check_database,
    init_database,
)

__all__ = [
    "InspectionRecord",
    "DefectRecord",
    "InspectionRepository",
    "init_database",
    "health_check_database",
]
