from repro_torch.roofline.analysis import (H100_SXM, HW, V5E, RooflineTerms,
                                           analyze_step, count_flops,
                                           model_flops, useful_ratio)
