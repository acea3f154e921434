from .inference import (inference_detector, init_model, make_predict_fn,
                        results_to_host, validate_dcn_offsets)
from .test import merge_flip_results, run_test

__all__ = ['inference_detector', 'init_model', 'make_predict_fn',
           'merge_flip_results', 'results_to_host', 'run_test',
           'validate_dcn_offsets']
