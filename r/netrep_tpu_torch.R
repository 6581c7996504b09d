# netrep-tpu R shim over the PyTorch/CUDA port (reticulate stub): the
# reference package's exported surface, forwarding to the port's
# package-level surface `netrep_tpu_torch.api` and its plot module
# `netrep_tpu_torch.plot`, never to the JAX package. docs/r-shim.md
# documents the mapping and the result object, which the port returns in
# the same shape.
#
# R is not installed on the machine that runs the tests, nor on the
# machine with the card, so this file is a *specification stub*: it is
# exercised for name/default parity against the port's Python signatures
# by tests/test_torch_r_shim.py (which parses this file and
# r/netrep_tpu.R), and is written to run unmodified in an R session that
# has reticulate + a Python environment with netrep_tpu_torch installed
# (or on sys.path):
#
#   source("r/netrep_tpu_torch.R")
#   res <- modulePreservation(network = list(d = dnet, t = tnet),
#                             data = list(d = ddat, t = tdat),
#                             correlation = list(d = dcor, t = tcor),
#                             moduleAssignments = labels,
#                             discovery = "d", test = "t", nPerm = 10000,
#                             device = "cuda")
#
# The 13 functions, their camelCase arguments, defaults and `.<fn>_args`
# mapping lists are r/netrep_tpu.R's own: this file sources it into the
# same environment and then redefines only the two Python handles
# (`.netrep`, `.callPlot`), which every shared function looks up when it
# is called, and the three functions that reach a device without taking
# `...` there (networkProperties, nodeOrder, sampleOrder).
#
# The port runs on the card unless told otherwise: `device` (default: the
# card; "cpu" for the plain versions on the host) rides through `...`
# with the port's other extras (seed, config, mesh, profile,
# checkpoint_dir, backend) under their Python names. requiredPerms is host
# arithmetic and takes none.

# this file's directory, from source()'s own frame ("r" when the file is
# evaluated some other way from the repository's root)
.netrep_tpu_torch_dir <- local({
  dir <- "r"
  for (frame in rev(sys.frames())) {
    if (!is.null(frame$ofile)) {
      dir <- dirname(frame$ofile)
      break
    }
  }
  dir
})

source(file.path(.netrep_tpu_torch_dir, "netrep_tpu.R"), local = environment())

.netrep <- local({
  mod <- NULL
  function() {
    if (is.null(mod)) mod <<- reticulate::import("netrep_tpu_torch.api")
    mod
  }
})

# r/netrep_tpu.R's plot glue with the port's plot module.
.callPlot <- function(py_name, args, orderArgs) {
  plt <- reticulate::import("netrep_tpu_torch.plot")
  is_order <- names(args) %in% names(orderArgs)
  args <- args[is_order | !vapply(args, is.null, logical(1))]
  for (nm in names(orderArgs)) {
    if (!nm %in% names(args)) args[nm] <- orderArgs[nm]
  }
  do.call(plt[[py_name]], args)
}

networkProperties <- function(network,
                              data = NULL,
                              correlation = NULL,
                              moduleAssignments = NULL,
                              modules = NULL,
                              backgroundLabel = "0",
                              discovery = NULL,
                              test = NULL,
                              selfPreservation = TRUE,
                              simplify = TRUE,
                              ...) {
  args <- list(network = network, data = data, correlation = correlation,
               module_assignments = moduleAssignments, modules = modules,
               background_label = backgroundLabel, discovery = discovery,
               test = test, self_preservation = selfPreservation,
               simplify = simplify, ...)
  args <- args[!vapply(args, is.null, logical(1))]
  do.call(.netrep()$network_properties, args)
}

nodeOrder <- function(network,
                      data = NULL,
                      correlation = NULL,
                      moduleAssignments = NULL,
                      modules = NULL,
                      backgroundLabel = "0",
                      discovery = NULL,
                      test = NULL,
                      orderNodesBy = "discovery",
                      ...) {
  .callPlot("node_order",
            list(network = network, data = data, correlation = correlation,
                 module_assignments = moduleAssignments, modules = modules,
                 background_label = backgroundLabel, discovery = discovery,
                 test = test, ...),
            list(order_nodes_by = orderNodesBy))
}

sampleOrder <- function(network,
                        data,
                        correlation = NULL,
                        moduleAssignments = NULL,
                        modules = NULL,
                        backgroundLabel = "0",
                        discovery = NULL,
                        test = NULL,
                        orderSamplesBy = "test",
                        ...) {
  .callPlot("sample_order",
            list(network = network, data = data, correlation = correlation,
                 module_assignments = moduleAssignments, modules = modules,
                 background_label = backgroundLabel, discovery = discovery,
                 test = test, ...),
            list(order_samples_by = orderSamplesBy))
}
