"""Training of the port's LM (``repro.training``'s counterpart): the
optimizers (``optimizer``), the train step with microbatch accumulation
on one device or a mesh, with its pod-manual variant (``trainer``), and
the int8 error-feedback pod reduction (``compression``)."""
