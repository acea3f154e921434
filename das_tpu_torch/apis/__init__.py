from .inference import (init_model, make_predict_fn, results_to_host,
                        validate_dcn_offsets)

__all__ = ['init_model', 'make_predict_fn', 'results_to_host',
           'validate_dcn_offsets']
