from .schedule import (PipeSchedule, TrainSchedule, InferenceSchedule, DataParallelSchedule,
                       FillDrainSchedule, ForwardPass, BackwardPass, SendActivation,
                       RecvActivation, SendGrad, RecvGrad, LoadMicroBatch, OptimizerStep,
                       ReduceGrads, ReduceTiedGrads)
from .module import PipelineModule, LayerSpec, TiedLayerSpec, partition_uniform, partition_balanced
