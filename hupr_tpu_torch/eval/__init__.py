from hupr_tpu_torch.eval.cocoeval import (
    HUPR_OKS_SIGMAS,
    KeypointEvaluator,
    KeypointEvalParams,
)
