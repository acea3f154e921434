from .inference import (inference_detector, init_model, make_predict_fn,
                        results_to_host, validate_dcn_offsets)
from .test import merge_flip_results, run_test
from .train import prefetch_to_device, train_model

__all__ = ['inference_detector', 'init_model', 'make_predict_fn',
           'merge_flip_results', 'prefetch_to_device', 'results_to_host',
           'run_test', 'train_model', 'validate_dcn_offsets']
