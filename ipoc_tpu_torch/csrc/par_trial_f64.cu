// The parallel trial's float64 instantiations (par_trial.cuh) at
// pendulum's, cartpole's and the nu > 1 layout pin's shapes, every lane
// count, in an object of their own.

#include "par_trial.cuh"

IPOC_TRIAL_ENTRIES(double, f64, ipoc_trial::Shape<2, 1>, ipoc_trial::Shape<4, 1>,
                   ipoc_trial::Shape<3, 2>)
