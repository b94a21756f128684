# R interface demo for mogp_tpu via reticulate.
#
# Counterpart of the reference's demos/gp_demo.R (which drives
# mogp_emulator through reticulate); the same pattern works unchanged
# against this framework because the Python API surface is
# preserved.
#
#   install.packages("reticulate")
#   source("gp_demo.R")

library(reticulate)

mogp <- import("mogp_tpu")
np <- import("numpy")

x <- np$array(matrix(c(1, 2, 3,
                       4, 5, 6,
                       7, 8, 9,
                       1, 3, 5,
                       5, 3, 1,
                       2, 4, 6,
                       6, 4, 2,
                       3, 3, 3), ncol = 3, byrow = TRUE))
y <- np$array(c(2, 4, 6, 3, 3, 4, 4, 3))

gp <- mogp$GaussianProcess(x, y, nugget = "adaptive")
gp <- mogp$fit_GP_MAP(gp, n_tries = 5L)

x_predict <- np$array(matrix(c(2, 3, 4,
                               7, 8, 9), ncol = 3, byrow = TRUE))
pred <- gp$predict(x_predict)

cat("means:    ", pred$mean, "\n")
cat("variances:", pred$unc, "\n")
